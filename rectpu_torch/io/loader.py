"""Input pipeline, CSV -> encoded batches: the port of ``rectpu/io/loader.py``.

The dataset is parsed and feature-encoded once into dense columnar numpy
arrays (global ids per field + float label); batch iteration is array
slicing. rectpu reads the CSV with pandas (or its native C++ loader); the
port reads it with the standard ``csv`` module and applies pandas' rules:
string columns stay strings (zipcode "03364" keeps its leading zero,
``loader.py:62-64``), pandas' missing-value tokens ("", "NA", "null", ...)
take the schema default (0 / "null"), numeric text parses as pandas'
``to_numeric(errors="coerce")`` does. Every other rule is rectpu's, so the
batch stream is the same as rectpu's ``CsvDataset``:

  - label = (rating >= cutoff), cutoff default 5 (trainers/ml_100k.py:48);
  - TRAIN shuffles and repeats forever, one full permutation per epoch from
    ``default_rng(SeedSequence([seed, epoch]))`` (:269-271), with an epoch's
    remainder rows carried into the next epoch's first batch;
  - EVAL is one ordered pass, the last batch zero-padded with weight 0.

``StreamingCsvDataset`` reads a file larger than memory in windows of
chunks, with rectpu's chunk and window order (below), so its batch stream is
rectpu's ``StreamingCsvDataset``'s.

Both datasets parse and encode through the native host library
(``io/native/csv_loader.cc``, a copy of rectpu's) unless ``use_native=False``
asks for the Python path above, which stays as the plain version the native
one is held against. ``use_native=None`` means native, as it does in rectpu
once its library is built; a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import csv
import dataclasses
import io
from pathlib import Path

import numpy as np

from rectpu_torch.features.schema import FeatureSet, column_default, is_string_column
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# pandas.read_csv's default missing-value tokens
_NA_TOKENS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])


@dataclasses.dataclass
class DataState:
    """Position of the input iterator, checkpointable for exact resume:
    ``index`` is the row offset within the current epoch's stream."""

    epoch: int = 0
    index: int = 0
    seed: int = 0


def _number(token: str, default, as_float: bool):
    if token in _NA_TOKENS:
        return default
    try:
        return float(token) if as_float else int(token)
    except ValueError:
        pass
    try:
        x = float(token)
    except ValueError:
        return default  # pandas' errors="coerce": NaN, then the default
    if x != x:
        return default
    return x if as_float else int(x)


def read_csv_columns(csv_path: str | Path | bytes, columns: list[str],
                     float_cols: set | frozenset = frozenset()) -> dict:
    """Read a CSV (a path, or the file's bytes) into {column -> np array},
    applying schema defaults.

    ``float_cols``: columns consumed as raw floats (NumericFeature), read as
    float64; other numeric columns are int64 (integer hashing stringifies
    decimally, so "3" must not become "3.0"). String columns come back as
    numpy str arrays."""
    with (io.StringIO(csv_path.decode("utf-8"), newline="") if isinstance(csv_path, bytes)
          else open(csv_path, newline="")) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return columns_from_rows(header, rows, columns, float_cols)


def columns_from_rows(header: list[str], rows: list[list[str]], columns: list[str],
                      float_cols: set | frozenset = frozenset()) -> dict:
    """``read_csv_columns`` on rows already split by ``csv.reader``."""
    pos = {name: i for i, name in enumerate(header)}
    out = {}
    for col in columns:
        default = column_default(col)
        i = pos.get(col)
        raw = [r[i] if i < len(r) else "" for r in rows] if i is not None else None
        if is_string_column(col):
            vals = ([str(default)] * len(rows) if raw is None else
                    [str(default) if t in _NA_TOKENS else t for t in raw])
            out[col] = np.array(vals, dtype=str) if vals else np.zeros(0, dtype=str)
        else:
            as_float = col in float_cols
            dtype = np.float64 if as_float else np.int64
            if raw is None:
                out[col] = np.full(len(rows), default, dtype=dtype)
            else:
                out[col] = np.array([_number(t, default, as_float) for t in raw], dtype=dtype)
    return out


def _encode_python(source: str | Path | bytes, feature_set: FeatureSet, label_col: str,
                   cutoff) -> dict:
    """The Python path: ``read_csv_columns`` (a path or the file's bytes),
    then ``FeatureSet.encode`` with the Python FarmHash -> {cat_ids,
    num_vals, labels}."""
    needed = [f.name for f in feature_set.categorical] + [f.name for f in feature_set.numeric]
    columns = read_csv_columns(source, needed + [label_col],
                               float_cols={f.name for f in feature_set.numeric})
    batch = feature_set.encode(columns, use_native=False)
    cat_ids = batch["cat_ids"]
    return {"cat_ids": cat_ids,
            "num_vals": batch.get("num_vals", np.zeros((cat_ids.shape[0], 0), np.float32)),
            "labels": (columns[label_col] >= cutoff).astype(np.float32)}


class CsvDataset:
    """A fully encoded, in-memory dataset ready for batching.

    Attributes:
        cat_ids: [N, F] int32 global embedding-row ids.
        num_vals: [N, D] float32 numeric features (D may be 0).
        labels: [N] float32 binary labels.
    """

    def __init__(self, csv_path: str | Path, feature_set: FeatureSet,
                 label_col: str = "rating", cutoff: int = 5, use_native: bool | None = None):
        self.feature_set = feature_set
        if use_native is not False:
            from rectpu_torch.io.native.csv_bridge import load_and_encode

            enc = load_and_encode(csv_path, feature_set, label_col, cutoff)
        else:
            enc = _encode_python(csv_path, feature_set, label_col, cutoff)
        self.cat_ids, self.num_vals, self.labels = enc["cat_ids"], enc["num_vals"], enc["labels"]
        self.size = self.cat_ids.shape[0]
        logger.debug("dataset loaded: %s rows from %s", self.size, csv_path)

    @classmethod
    def from_arrays(cls, cat_ids, labels, num_vals=None, feature_set=None):
        ds = cls.__new__(cls)
        ds.feature_set = feature_set
        ds.cat_ids = np.asarray(cat_ids, dtype=np.int32)
        ds.labels = np.asarray(labels, dtype=np.float32)
        ds.num_vals = (np.asarray(num_vals, dtype=np.float32) if num_vals is not None
                       else np.zeros((ds.cat_ids.shape[0], 0), dtype=np.float32))
        ds.size = ds.cat_ids.shape[0]
        return ds

    def apply_row_permutation(self, perm: np.ndarray) -> None:
        """Relabel the encoded row ids in place, id -> perm[id] (a stored row
        placement, ``rectpu/io/loader.py:153``)."""
        self.cat_ids = np.asarray(perm, dtype=np.int32)[self.cat_ids]

    def train_index_batches(self, batch_size: int, state: DataState | None = None,
                            seed: int = 0, shard_id: int = 0, num_shards: int = 1):
        """Infinite shuffled row-index batches of shape [batch_size]: yields
        (row_indices int64, DataState after the batch). ``train_batches``
        materializes the same batches.

        Sharded (``rectpu/io/loader.py:166-206``): every shard walks the same
        epoch stream in global batches of ``batch_size * num_shards`` and
        takes the contiguous block ``[shard_id * batch_size, (shard_id + 1)
        * batch_size)`` of each, so the shards' blocks in order are the
        single-process batch, row for row; ``DataState.index`` is the global
        offset, the same on every shard."""
        state = state or DataState(seed=seed)
        epoch, index = state.epoch, state.index
        gbs = batch_size * num_shards
        lo, hi = shard_id * batch_size, (shard_id + 1) * batch_size
        perm = self._perm(epoch, state.seed)
        carry = np.empty((0,), dtype=perm.dtype)
        while True:
            take = gbs - carry.shape[0]
            if index + take <= perm.shape[0]:
                sel = perm[index: index + take]
                index += take
                rows = np.concatenate([carry, sel]) if carry.size else sel
                carry = np.empty((0,), dtype=perm.dtype)
                yield rows[lo:hi], DataState(epoch=epoch, index=index, seed=state.seed)
            else:
                carry = np.concatenate([carry, perm[index:]])
                epoch += 1
                index = 0
                perm = self._perm(epoch, state.seed)

    def train_batches(self, batch_size: int, state: DataState | None = None, seed: int = 0,
                      shard_id: int = 0, num_shards: int = 1):
        """Infinite shuffled batches {cat_ids, num_vals, labels} with the
        DataState after each (a shard's block of each global batch, as
        ``train_index_batches``)."""
        for rows, st in self.train_index_batches(batch_size, state=state, seed=seed,
                                                 shard_id=shard_id, num_shards=num_shards):
            yield {"cat_ids": self.cat_ids[rows], "num_vals": self.num_vals[rows],
                   "labels": self.labels[rows]}, st

    def eval_batches(self, batch_size: int, shard_id: int = 0, num_shards: int = 1):
        """One ordered pass; the last batch is zero-padded with weight 0.
        Sharded, each shard walks the rows ``[shard_id::num_shards]`` and every
        shard yields the same number of batches (trailing all-padding ones
        where it runs short), since the sharded eval runs collectives each
        batch (``rectpu/io/loader.py:241-252``)."""
        rows = np.arange(self.size)[shard_id::num_shards]
        max_shard_rows = -(-self.size // num_shards)
        n_batches = max(-(-max_shard_rows // batch_size), 1)
        for b in range(n_batches):
            sel = rows[b * batch_size: (b + 1) * batch_size]
            n = sel.shape[0]
            ids, num, lab = self.cat_ids[sel], self.num_vals[sel], self.labels[sel]
            w = np.ones((n,), dtype=np.float32)
            if n < batch_size:
                pad = batch_size - n
                ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), dtype=np.int32)])
                num = np.concatenate([num, np.zeros((pad, num.shape[1]), dtype=np.float32)])
                lab = np.concatenate([lab, np.zeros((pad,), dtype=np.float32)])
                w = np.concatenate([w, np.zeros((pad,), dtype=np.float32)])
            yield {"cat_ids": ids, "num_vals": num, "labels": lab, "weights": w}

    def _perm(self, epoch: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        return rng.permutation(self.size)


class StreamingCsvDataset:
    """Out-of-core CSV dataset: windows of chunks are parsed and encoded on
    demand, so the file is never resident (``rectpu/io/loader.py:274-588``,
    its pure-Python path).

    The iteration contract is ``CsvDataset``'s: batches of static shape, a
    checkpointable ``DataState``, sharding, a padded eval. The shuffle:
    per epoch the CHUNK order is permuted (``SeedSequence([seed, epoch, 7])``),
    each shard takes ``chunk_perm[shard::num_shards]``, its chunks are
    grouped into windows of ``window_chunks``, and the rows of a loaded
    window are permuted (``SeedSequence([seed, epoch, window, 13])``); a
    batch that straddles two windows (or two epochs) takes the rest of one
    and the head of the next. A background thread parses the next window
    while the current one is consumed. ``DataState.index`` counts the rows
    of this shard's epoch stream consumed, so a resume re-derives the
    windows from (seed, epoch) and skips to the one that holds ``index``.

    A window is parsed and encoded by the native library
    (``csv_bridge.encode_bytes``) unless ``use_native=False``.
    """

    def __init__(self, csv_path: str | Path, feature_set: FeatureSet,
                 label_col: str = "rating", cutoff: int = 5, chunk_rows: int = 65536,
                 window_chunks: int = 4, use_native: bool | None = None,
                 prefetch: bool = True):
        self.use_native = use_native is not False
        self.csv_path = Path(csv_path)
        self.feature_set = feature_set
        self.label_col = label_col
        self.cutoff = cutoff
        self.chunk_rows = chunk_rows
        self.window_chunks = max(1, window_chunks)
        self.prefetch = prefetch
        self._row_perm = None
        self._scan()

    def apply_row_permutation(self, perm: np.ndarray) -> None:
        """Relabel the row ids (id -> perm[id]) of every window as it is
        encoded (a stored row placement)."""
        self._row_perm = np.asarray(perm, dtype=np.int32)

    def _scan(self, block_size: int = 1 << 24) -> None:
        """Record the byte offset of every chunk_rows-th data line. A newline
        ends a row only after an even number of quotes, so a newline inside a
        quoted field does not split it."""
        offsets = []
        n_rows = 0
        quotes_so_far = 0  # quotes before this block: its parity is the quoted state
        header_end = None
        file_pos = 0
        pending_row_start = None  # byte offset where the next row starts
        with open(self.csv_path, "rb") as f:
            while block := f.read(block_size):
                arr = np.frombuffer(block, np.uint8)
                nl_pos = np.flatnonzero(arr == 0x0A)
                if quotes_so_far % 2 == 0 and 0x22 not in arr:
                    row_ends = nl_pos
                else:
                    q_pos = np.flatnonzero(arr == 0x22)
                    before = np.searchsorted(q_pos, nl_pos) + quotes_so_far
                    row_ends = nl_pos[before % 2 == 0]
                    quotes_so_far += q_pos.shape[0]
                for nl in row_ends.tolist():
                    pos = file_pos + nl + 1
                    if header_end is None:
                        header_end = pos
                    else:
                        if n_rows % self.chunk_rows == 0:
                            offsets.append(pending_row_start)
                        n_rows += 1
                    pending_row_start = pos
                file_pos += len(block)
        file_size = file_pos
        if pending_row_start is not None and pending_row_start < file_size:
            # a last row without a newline
            if n_rows % self.chunk_rows == 0:
                offsets.append(pending_row_start)
            n_rows += 1
        if header_end is None:
            raise ValueError(f"{self.csv_path}: no header line")
        with open(self.csv_path, "rb") as f:
            self._header = f.read(header_end)
        self.size = n_rows
        self._chunk_offsets = offsets + [file_size]
        self.num_chunks = len(offsets)
        self._chunk_sizes = [min(self.chunk_rows, n_rows - i * self.chunk_rows)
                             for i in range(self.num_chunks)]
        logger.debug("streaming dataset indexed: %s rows, %s chunks from %s", n_rows,
                     self.num_chunks, self.csv_path)

    def _load_window(self, chunk_ids) -> dict:
        """Parse and encode the header plus the given chunks."""
        parts = [self._header]
        with open(self.csv_path, "rb") as f:
            for c in chunk_ids:
                f.seek(self._chunk_offsets[c])
                parts.append(f.read(self._chunk_offsets[c + 1] - self._chunk_offsets[c]))
        data = b"".join(parts)
        if self.use_native:
            from rectpu_torch.io.native.csv_bridge import encode_bytes

            enc = encode_bytes(data, self.feature_set, self.label_col, self.cutoff)
        else:
            enc = _encode_python(data, self.feature_set, self.label_col, self.cutoff)
        if self._row_perm is not None:
            enc["cat_ids"] = self._row_perm[enc["cat_ids"]]
        return enc

    def _epoch_windows(self, epoch: int, seed: int, shard_id: int, num_shards: int):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 7]))
        chunk_perm = rng.permutation(self.num_chunks)[shard_id::num_shards]
        wc = self.window_chunks
        windows = [chunk_perm[i:i + wc] for i in range(0, len(chunk_perm), wc)]
        sizes = [int(sum(self._chunk_sizes[c] for c in w)) for w in windows]
        return windows, sizes

    def _window_rows(self, epoch: int, w_idx: int, window, seed: int) -> dict:
        enc = self._load_window(window)
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, w_idx, 13]))
        perm = rng.permutation(enc["labels"].shape[0])
        return {k: v[perm] for k, v in enc.items()}

    def train_batches(self, batch_size: int, state: DataState | None = None, seed: int = 0,
                      shard_id: int = 0, num_shards: int = 1):
        """Infinite batches {cat_ids, num_vals, labels} of ``batch_size`` rows,
        each with the DataState after it."""
        state = state or DataState(seed=seed)
        epoch, index = state.epoch, state.index
        pool = (concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="rectpu-stream")
                if self.prefetch else None)

        def load(ep, w_idx, window):
            if pool is None:
                return self._window_rows(ep, w_idx, window, state.seed)
            return pool.submit(self._window_rows, ep, w_idx, window, state.seed)

        carry = None
        fut = None
        try:
            while True:
                windows, sizes = self._epoch_windows(epoch, state.seed, shard_id, num_shards)
                if not windows:
                    raise ValueError(f"shard {shard_id}/{num_shards} received no chunks "
                                     f"({self.num_chunks} total); lower chunk_rows or shards")
                starts = np.concatenate([[0], np.cumsum(sizes)])
                # a resume starts in the window that holds `index`
                w_idx = min(int(np.searchsorted(starts, index, side="right") - 1),
                            len(windows) - 1)
                while w_idx < len(windows):
                    if fut is not None:
                        rows = fut.result()
                    else:
                        rows = load(epoch, w_idx, windows[w_idx])
                        rows = rows.result() if pool is not None else rows
                    fut = None
                    if pool is not None:  # the next window (or the next epoch's first)
                        if w_idx + 1 < len(windows):
                            fut = load(epoch, w_idx + 1, windows[w_idx + 1])
                        else:
                            nw, _ = self._epoch_windows(epoch + 1, state.seed, shard_id,
                                                        num_shards)
                            fut = load(epoch + 1, 0, nw[0]) if nw else None
                    local = index - int(starts[w_idx])  # offset within the window
                    n_w = rows["labels"].shape[0]
                    while local < n_w:
                        have = 0 if carry is None else carry["labels"].shape[0]
                        take = min(batch_size - have, n_w - local)
                        piece = {k: v[local:local + take] for k, v in rows.items()}
                        local += take
                        index += take
                        if carry is not None:
                            piece = {k: np.concatenate([carry[k], piece[k]]) for k in piece}
                            carry = None
                        if piece["labels"].shape[0] == batch_size:
                            yield piece, DataState(epoch=epoch, index=index, seed=state.seed)
                        else:
                            carry = piece
                    w_idx += 1
                epoch += 1
                index = 0
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def eval_batches(self, batch_size: int, shard_id: int = 0, num_shards: int = 1):
        """One ordered pass, a chunk at a time, with ``CsvDataset``'s padding:
        each shard walks the global rows [shard::num_shards], and every shard
        yields the same number of batches (trailing all-padding ones)."""
        max_shard_rows = -(-self.size // num_shards)
        n_batches = max(-(-max_shard_rows // batch_size), 1)
        buf = None
        emitted = 0
        global_row = 0

        def emit(piece):
            n = piece["labels"].shape[0]
            w = np.ones((n,), np.float32)
            if n < batch_size:
                pad = batch_size - n
                piece = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                         for k, v in piece.items()}
                w = np.concatenate([w, np.zeros((pad,), np.float32)])
            piece["weights"] = w
            return piece

        for c in range(self.num_chunks):
            enc = self._load_window([c])
            n = enc["labels"].shape[0]
            mask = (np.arange(global_row, global_row + n) % num_shards) == shard_id
            global_row += n
            piece = {k: v[mask] for k, v in enc.items()}
            buf = piece if buf is None else {k: np.concatenate([buf[k], piece[k]])
                                             for k in piece}
            while buf["labels"].shape[0] >= batch_size:
                out = {k: v[:batch_size] for k, v in buf.items()}
                buf = {k: v[batch_size:] for k, v in buf.items()}
                emitted += 1
                yield emit(out)
        if buf is not None and buf["labels"].shape[0] and emitted < n_batches:
            emitted += 1
            yield emit(buf)
        while emitted < n_batches:
            emitted += 1
            yield emit({"cat_ids": np.zeros((0, self.feature_set.num_fields), np.int32),
                        "num_vals": np.zeros((0, self.feature_set.num_numeric), np.float32),
                        "labels": np.zeros((0,), np.float32)})
