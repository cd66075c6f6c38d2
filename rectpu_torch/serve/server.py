"""Minimal JSON prediction server over an exported model (the port of
``rectpu/serve/server.py``: same routes, same request and response JSON).

Replaces the reference's ML-Engine model deployment (reference
scripts/mle_deploy.sh: find latest export -> create model version -> online
predict). Here::

    python -m rectpu_torch.serve.server --job-dir checkpoints/deep_fm [--device cuda]

serves the newest export under job_dir (one rectpu or this package wrote) at
POST /predict with the ML-Engine request shape:

    {"instances": [{"user_id": 1, "item_id": 10, "age": 25, "gender": "F",
                    "occupation": "student", "zipcode": "85711",
                    "release_year": 1994, "action": 1}, ...]}

Response: {"predictions": [{"probabilities": p, "logistic": p, "logits": l,
"class_id": c}]} — the reference binary head's full output set. GET /healthz
and /metrics as in rectpu. Stdlib http.server only. The model runs on the
card (``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from rectpu_torch.serve.export import SERVING_REQUIRED, latest_export, load_model
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def instances_to_columns(instances: list[dict]) -> dict:
    columns: dict = {}
    keys = set()
    for inst in instances:
        keys.update(inst.keys())
    for key in keys:
        columns[key] = np.asarray([inst.get(key, 0) for inst in instances])
    return columns


def parse_request_columns(raw: bytes) -> tuple[dict, int]:
    """Request body bytes -> (columns dict, n_rows), through ``json.loads``
    (rectpu's defining path; its native JSON-column parser is not ported yet,
    ROADMAP.md queue A)."""
    body = json.loads(raw or b"{}")
    instances = body["instances"]
    return instances_to_columns(instances), len(instances)


class UnknownVersion(KeyError):
    """Requested model version does not exist (maps to HTTP 404)."""


class ModelVersions:
    """ML-Engine-style model/version registry over a job dir.

    Every export under ``<job_dir>/export/exporter/<ts>/`` is a servable
    version named by its timestamp (the reference's ``gcloud ml-engine
    versions create v1 --origin <latest export>`` flow,
    reference scripts/mle_deploy.sh:9-16 — here ALL exported versions
    stay addressable, newest = default). Versions load lazily on first
    request; the default loads eagerly at startup.

    The export dir is RE-SCANNED on every listing/lookup: training may still
    be running in the same job dir, pruning old exports (keep-5) and writing
    new ones — new versions become servable lazily, pruned ones disappear
    from the listing (already-loaded ones keep serving from memory). Loading
    happens under a PER-VERSION lock so a slow lazy load (the first load of a
    process builds the kernels) never blocks requests to versions that are
    already loaded.
    """

    def __init__(self, job_dir, model_name: str, loader, wrap=None,
                 warmup_sizes=(1, 2, 8, 64, 512), follow_latest: bool = False):
        import threading
        from pathlib import Path

        self.model_name = model_name
        self._loader = loader  # (export_dir) -> ServingModel
        self._wrap = wrap or (lambda served: served)  # e.g. MicroBatcher
        self._warmup_sizes = tuple(warmup_sizes)
        # follow_latest: the default version tracks the newest export on disk
        # (continuous deployment: training's LatestExporter keeps writing,
        # the server hot-picks each new export on its next default request)
        self._follow_latest = bool(follow_latest)
        self._base = Path(job_dir) / "export" / "exporter"
        dirs = self._scan()
        if not dirs:
            raise FileNotFoundError(f"no exports under {self._base}")
        self._pinned_default = self._newest(dirs)
        self._loaded: dict = {}
        self._loading: dict = {}  # version -> per-version load lock
        self._lock = threading.Lock()

    @staticmethod
    def _newest(dirs) -> str:
        # newest timestamp wins; non-numeric names (e.g. a quantized artifact
        # written into the exporter dir) never outrank a timestamped export
        return max(
            dirs, key=lambda v: (v.isdigit(), int(v) if v.isdigit() else 0, v)
        )

    @property
    def default_version(self) -> str:
        if self._follow_latest:
            dirs = self._scan()
            if dirs:
                return self._newest(dirs)
        return self._pinned_default

    def _scan(self) -> dict:
        if not self._base.exists():
            return {}
        return {
            p.name: p
            for p in sorted(self._base.iterdir())
            if p.is_dir() and not p.name.startswith(".") and (p / "model.json").exists()
        }

    def versions(self) -> list[str]:
        with self._lock:
            loaded = set(self._loaded)
        return sorted(set(self._scan()) | loaded)

    def loaded_stats(self, stats_fn) -> dict:
        with self._lock:
            loaded = dict(self._loaded)
        return {v: stats_fn(t) for v, t in loaded.items()}

    def get(self, version: str | None = None):
        import threading

        v = version or self.default_version
        with self._lock:
            hit = self._loaded.get(v)
            if hit is not None:
                return hit
            load_lock = self._loading.setdefault(v, threading.Lock())
        with load_lock:
            with self._lock:
                hit = self._loaded.get(v)
                if hit is not None:
                    return hit
            dirs = self._scan()
            if v not in dirs:
                raise UnknownVersion(
                    f"unknown version {v!r} of model {self.model_name!r}")
            served = self._loader(dirs[v])
            served.warmup(sizes=self._warmup_sizes)
            wrapped = self._wrap(served)
            with self._lock:
                self._loaded[v] = wrapped
        return wrapped

    def listing(self) -> dict:
        name = f"models/{self.model_name}"
        return {
            "name": name,
            "defaultVersion": {"name": f"{name}/versions/{self.default_version}"},
            "versions": [{"name": f"{name}/versions/{v}"} for v in self.versions()],
        }


def _route(path: str, versions: "ModelVersions | None"):
    """Resolve a POST path to a (version | None, ok) pair.

    Accepts the flat routes (/predict, /v1/predict) and, when a registry is
    active, /v1/models/<name>:predict and /v1/models/<name>/versions/<v>:predict."""
    flat = path.rstrip("/") in ("/predict", "/v1/predict", "")
    if flat:
        return None, True
    if versions is not None and path.startswith("/v1/models/") and path.endswith(":predict"):
        middle = path[len("/v1/models/"):-len(":predict")]
        parts = middle.split("/")
        if parts[0] != versions.model_name:
            return None, False
        if len(parts) == 1:
            return None, True
        if len(parts) == 3 and parts[1] == "versions":
            return parts[2], True
    return None, False


def _server_metrics(served, versions: "ModelVersions | None") -> dict:
    """Stats for /metrics: request/latency counters plus, when micro-batching
    is on, the batcher's coalescing counters (MicroBatcher.requests_served
    etc.). With a version registry, per-loaded-version stats."""

    def one(target):
        m = {}
        for k in ("requests_served", "batches_dispatched", "rows_dispatched"):
            if hasattr(target, k):
                m[k] = getattr(target, k)
        if m.get("batches_dispatched"):
            m["rows_per_batch"] = round(m["rows_dispatched"] / m["batches_dispatched"], 2)
        return m

    if versions is not None:
        return {
            "model": versions.model_name,
            "default_version": versions.default_version,
            "versions_available": versions.versions(),
            "versions_loaded": versions.loaded_stats(one),
        }
    return one(served)


def make_handler(served, versions: "ModelVersions | None" = None):
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            version, ok = _route(self.path, versions)
            if not ok:
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                columns, n_rows = parse_request_columns(self.rfile.read(length))
                target = versions.get(version) if versions is not None else served
                out = target.predict(columns)
                predictions = [
                    {
                        "probabilities": float(out["probabilities"][i]),
                        # full binary-head output set (ref model_utils.py:9-20;
                        # logistic == probabilities for this head, emitted for
                        # response-schema parity with TF serving)
                        "logistic": float(out["logistic"][i]),
                        "logits": float(out["logits"][i]),
                        "class_id": int(out["class_id"][i]),
                    }
                    for i in range(n_rows)
                ]
                payload = json.dumps({"predictions": predictions}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            except Exception as e:  # surface the error to the client
                payload = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                # only a missing VERSION is a 404; any other KeyError (e.g. a
                # body without "instances") is a client error like before
                self.send_response(404 if isinstance(e, UnknownVersion) else 400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        def do_GET(self):
            path = self.path.rstrip("/")
            if path == "/healthz":
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")
            elif path == "/metrics":
                payload = json.dumps(_server_metrics(served, versions)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            elif (
                versions is not None
                and path == f"/v1/models/{versions.model_name}"
            ):
                payload = json.dumps(versions.listing()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self.send_error(404)

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

    return Handler


def make_server(job_dir: str | None = None, export_dir: str | None = None,
                host: str = "127.0.0.1", port: int = 8080, device: str = "cuda",
                use_serialized: bool = False, batch_window_ms: float = 2.0,
                max_in_flight: int = 4, num_dispatchers: int = 1,
                table_quant: str | None = None, all_versions: bool = False,
                model_name: str = "default", follow_latest: bool = False):
    """Load, warm up and wrap the served model(s) and bind the HTTP server.

    Returns ``(httpd, served)``: ``httpd.serve_forever()`` answers requests
    (``serve`` does that), and ``served`` is the default model as the handler
    sees it (a ``MicroBatcher`` when batching is on, which the caller closes
    after ``httpd.shutdown()``)."""
    if use_serialized:
        raise NotImplementedError(
            "--serialized: rectpu's apply.jaxexport StableHLO graph has no PyTorch "
            "counterpart yet (ROADMAP.md queue A, serving)")
    if table_quant:
        raise NotImplementedError(
            "--table-quant int8 is not ported to rectpu_torch yet (ROADMAP.md queue A, "
            "serving)")

    def loader(edir):
        return load_model(edir, device=device)

    def wrap(m):
        if batch_window_ms <= 0:
            return m
        # coalesce concurrent requests into one device dispatch (ML-Engine
        # server-side batching parity); the handler only needs .predict()
        from rectpu_torch.serve.batching import MicroBatcher

        return MicroBatcher(m, max_delay_ms=batch_window_ms,
                            max_in_flight=max_in_flight,
                            num_dispatchers=num_dispatchers)

    versions = None
    if all_versions:
        if export_dir is not None:
            raise ValueError("--all-versions serves a job dir, not --export-dir")
        # every export stays addressable: /v1/models/<name>/versions/<ts>:predict
        versions = ModelVersions(job_dir, model_name, loader, wrap,
                                 follow_latest=follow_latest)
        served = versions.get()  # loads + warms the default (newest) version
        logger.info(
            "serving model %r versions %s (default %s) from %s",
            model_name, versions.versions(), versions.default_version, job_dir,
        )
    else:
        if export_dir is None:
            export_dir = latest_export(job_dir)
            if export_dir is None:
                raise FileNotFoundError(f"no export under {job_dir}/export/exporter")
        base = loader(export_dir)
        logger.info("serving %s on %s (required features: %s)", export_dir,
                    base.device, SERVING_REQUIRED)
        base.warmup(sizes=(1, 2, 8, 64, 512))
        served = wrap(base)
        if batch_window_ms > 0:
            logger.info("request micro-batching on (window %.1f ms)", batch_window_ms)
    httpd = ThreadingHTTPServer((host, port), make_handler(served, versions))
    logger.info("listening on http://%s:%d/predict", host, httpd.server_address[1])
    return httpd, served


def serve(**kwargs):
    """``make_server(**kwargs)``, then answer requests until interrupted."""
    httpd, _ = make_server(**kwargs)
    httpd.serve_forever()


if __name__ == "__main__":
    ap = ArgumentParser()
    ap.add_argument("--job-dir", default="checkpoints/deep_fm",
                    help="job dir whose newest export to serve")
    ap.add_argument("--export-dir", default=None, help="explicit export directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on: cuda (default; raises without "
                         "a GPU) or cpu")
    ap.add_argument("--serialized", action="store_true",
                    help="rectpu's StableHLO graph (not ported: raises)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="coalesce concurrent requests into one device call, "
                         "waiting up to this long to fill a batch (0 disables)")
    ap.add_argument("--max-in-flight", type=int, default=4,
                    help="batches allowed in flight on the device before the "
                         "dispatcher backpressures (pipelining depth)")
    ap.add_argument("--table-quant", choices=["int8"], default=None,
                    help="int8 table quantization (not ported: raises)")
    ap.add_argument("--num-dispatchers", type=int, default=1,
                    help="dispatcher threads: 1 = pipelined single dispatcher; "
                         ">1 = pool overlapping dispatch round trips")
    ap.add_argument("--all-versions", action="store_true",
                    help="serve EVERY export under the job dir as an "
                         "addressable version (/v1/models/<name>/versions/"
                         "<ts>:predict; newest = default), ML-Engine style")
    ap.add_argument("--model-name", default="default",
                    help="model name for the /v1/models/<name> routes")
    ap.add_argument("--follow-latest", action="store_true",
                    help="with --all-versions: the default version tracks the "
                         "newest export on disk")
    a = ap.parse_args()
    serve(job_dir=a.job_dir, export_dir=a.export_dir, host=a.host, port=a.port,
          device=a.device, use_serialized=a.serialized,
          batch_window_ms=a.batch_window_ms, max_in_flight=a.max_in_flight,
          num_dispatchers=a.num_dispatchers, table_quant=a.table_quant,
          all_versions=a.all_versions, model_name=a.model_name,
          follow_latest=a.follow_latest)
