"""MovieLens-100K ETL: the port of ``rectpu/data/ml_100k.py``.

Raw GroupLens files -> enriched train/test/all/users/items CSVs, with the
reference ETL's output schema: zipcode prefixes, the 'unknown' title dropped,
release_date/release_year, the timestamp's calendar fields, inner joins
(``load_data``, ``enrich_*``, ``process_data``, ``save_data``). The port
needs no pandas (the machine with the card has none): a table is a
``Frame`` of column lists, and each step reproduces what rectpu's pandas
calls do, so that both packages write the same bytes:

  - ``read_csv`` (latin-1, no header): blank lines skipped; a field in
    pandas' default NA set is missing; a column whose present values are all
    integers is int64, or float64 if one is missing; otherwise numbers are
    float64 and anything else a string;
  - ``merge(..., "inner", on=key)``: the left rows in order, each repeated
    for every matching right row in the right table's order; missing keys
    match each other;
  - ``to_datetime``: unix seconds as naive UTC, ``release`` by "%d-%b-%Y"
    with a failure (or a missing value) as NaT, whose year makes
    ``release_year`` a float64 column;
  - ``isocalendar().week`` and ``dayofweek + 1`` (Monday = 1);
  - ``to_csv(index=False)`` in utf-8: minimal quoting, "\\n" line ends, a
    missing value as an empty field, float64 as Python's repr (1995.0), a
    datetime column as "%Y-%m-%d" when every value is a midnight and
    "%Y-%m-%d %H:%M:%S" otherwise.

``local --synthetic`` writes the schema-identical synthetic data instead of
downloading (``rectpu_torch.data.synthetic``, byte-identical to rectpu's).
The ``gcp`` subcommand runs the BigQuery pipeline (``data/bigquery.py``).

    python -m rectpu_torch.data.ml_100k local --synthetic [--dest data]
"""

from __future__ import annotations

import csv
import re
from argparse import ArgumentParser
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from pathlib import Path
from zipfile import ZipFile

from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_URL = "http://files.grouplens.org/datasets/movielens/ml-100k.zip"

# Interaction tables share one layout; "all" is the full log, train/test are
# MovieLens' predefined ua.base/ua.test split (10 held-out ratings per user).
RATING_COLUMNS = ("user_id", "item_id", "rating", "timestamp")
RATING_TABLES = ("all", "train", "test")

GENRE_FLAGS = (
    "unknown", "action", "adventure", "animation", "children", "comedy", "crime",
    "documentary", "drama", "fantasy", "filmnoir", "horror", "musical", "mystery",
    "romance", "scifi", "thriller", "war", "western",
)


@dataclass(frozen=True)
class RawTable:
    """One raw GroupLens file: where it lives and how to parse it."""

    filename: str
    sep: str
    columns: tuple


RAW_TABLES = {
    "users": RawTable("u.user", "|", ("user_id", "age", "gender", "occupation", "zipcode")),
    "items": RawTable("u.item", "|", ("item_id", "title", "release", "video_release", "imdb")
                      + GENRE_FLAGS),
    "all": RawTable("u.data", "\t", RATING_COLUMNS),
    "train": RawTable("ua.base", "\t", RATING_COLUMNS),
    "test": RawTable("ua.test", "\t", RATING_COLUMNS),
}

# rectpu's mapping shape (name -> {filename, sep, columns})
DATA_CONFIG = {
    name: {"filename": t.filename, "sep": t.sep, "columns": list(t.columns)}
    for name, t in RAW_TABLES.items()
}

# pandas.read_csv's default NA strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Infinity)\Z",
                    re.IGNORECASE)
_EPOCH = datetime(1970, 1, 1)


@dataclass
class Frame:
    """A table: ``data`` maps each column, in order, to its values (None for
    missing); ``kinds`` gives each column's type: "int", "float", "str" or
    "datetime"."""

    data: dict = field(default_factory=dict)
    kinds: dict = field(default_factory=dict)

    @property
    def columns(self) -> list:
        return list(self.data)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def add(self, name: str, values: list, kind: str) -> None:
        self.data[name] = values
        self.kinds[name] = kind

    def take(self, rows: list) -> Frame:
        """The rows at the given indices, in that order."""
        return Frame({c: [v[i] for i in rows] for c, v in self.data.items()}, dict(self.kinds))


def _typed_column(raw: list) -> tuple[list, str]:
    """read_csv's inference for one column of raw strings."""
    vals = [None if s in _NA else s for s in raw]
    present = [s for s in vals if s is not None]
    if present and all(_INT.match(s) for s in present):
        if len(present) == len(vals):
            return [int(s) for s in vals], "int"
        return [None if s is None else float(int(s)) for s in vals], "float"
    if present and all(_FLOAT.match(s) for s in present):
        return [None if s is None else float(s) for s in vals], "float"
    if not present:
        return vals, "float"  # an all-NA column is float64 in pandas
    return vals, "str"


def read_table(path, spec: RawTable) -> Frame:
    """One raw file as ``pd.read_csv(path, sep, header=None, names=columns,
    encoding="latin-1")`` parses it."""
    with open(path, encoding="latin-1", newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=spec.sep) if r]
    frame = Frame()
    for j, name in enumerate(spec.columns):
        values, kind = _typed_column([r[j] if j < len(r) else "" for r in rows])
        frame.add(name, values, kind)
    return frame


def download_data(url: str = DEFAULT_URL, dest_dir: str = "data") -> None:
    """Fetch and unpack the ml-100k archive; no-op for pieces already present."""
    import shutil
    import urllib.request

    archive = Path(dest_dir) / Path(url).name
    archive.parent.mkdir(parents=True, exist_ok=True)

    if not archive.exists():
        logger.info("etl: fetching %s", url)
        tmp = archive.with_suffix(archive.suffix + ".part")
        with urllib.request.urlopen(url, timeout=60) as response, tmp.open("wb") as out:
            shutil.copyfileobj(response, out, 1 << 20)
        tmp.rename(archive)
        logger.info("etl: archive at %s (%d bytes)", archive, archive.stat().st_size)

    if not Path(dest_dir, "ml-100k", "README").exists():
        with archive.open("rb") as f, ZipFile(f, "r") as zf:
            zf.extractall(dest_dir)
        logger.info("etl: archive unpacked under %s", dest_dir)


def load_data(src_dir: str = "data/ml-100k") -> dict:
    """Parse the five raw tables into Frames keyed by table name."""
    tables = {}
    for name, spec in RAW_TABLES.items():
        tables[name] = read_table(Path(src_dir, spec.filename), spec)
        logger.debug("etl: parsed %s (%d rows) from %s", name, len(tables[name]), spec.filename)
    logger.info("etl: %d raw tables parsed from %s", len(tables), src_dir)
    return tables


def _as_str(value, kind: str) -> str | None:
    """pandas' ``astype(str)`` of one value (pandas 3 keeps a missing value
    missing)."""
    if value is None:
        return None
    if kind == "float":
        return repr(float(value))
    return str(value)


def enrich_users(users: Frame) -> Frame:
    """Add zipcode1/2/3 prefix columns (region granularity ladder)."""
    out = Frame(dict(users.data), dict(users.kinds))
    zipcode = [_as_str(v, users.kinds["zipcode"]) for v in users.data["zipcode"]]
    for width in (1, 2, 3):
        out.add(f"zipcode{width}", [None if z is None else z[:width] for z in zipcode], "str")
    return out


def _parse_release(value) -> datetime | None:
    if not isinstance(value, str):
        return None
    try:
        return datetime.strptime(value, "%d-%b-%Y")
    except ValueError:
        return None


def enrich_items(items: Frame) -> Frame:
    """Drop the placeholder 'unknown' title; derive release_date/release_year."""
    out = items.take([i for i, t in enumerate(items.data["title"]) if t != "unknown"])
    dates = [_parse_release(v) for v in out.data["release"]]
    out.add("release_date", dates, "datetime")
    if any(d is None for d in dates):  # NaT makes the year column float64
        out.add("release_year", [None if d is None else float(d.year) for d in dates], "float")
    else:
        out.add("release_year", [d.year for d in dates], "int")
    return out


def merge_inner(left: Frame, right: Frame, key: str) -> Frame:
    """``left.merge(right, "inner", key)``: left rows in order, each
    repeated for its matches in the right table's order; the key column is
    the left's, the right's other columns follow the left's."""
    matches: dict = {}
    for j, k in enumerate(right.data[key]):
        matches.setdefault(k, []).append(j)
    li, ri = [], []
    for i, k in enumerate(left.data[key]):
        for j in matches.get(k, ()):
            li.append(i)
            ri.append(j)
    out = left.take(li)
    for c, values in right.data.items():
        if c != key:
            out.add(c, [values[j] for j in ri], right.kinds[c])
    return out


def enrich_interactions(ratings: Frame, users: Frame, items: Frame) -> Frame:
    """Expand the unix timestamp into calendar fields, then attach user and
    item attributes by inner join (rows whose user or item was dropped
    upstream disappear here too)."""
    out = Frame(dict(ratings.data), dict(ratings.kinds))
    when = [_EPOCH + timedelta(seconds=int(s)) for s in ratings.data["timestamp"]]
    out.add("datetime", when, "datetime")
    out.add("year", [w.year for w in when], "int")
    out.add("month", [w.month for w in when], "int")
    out.add("day", [w.day for w in when], "int")
    out.add("week", [w.isocalendar()[1] for w in when], "int")
    out.add("dayofweek", [w.weekday() + 1 for w in when], "int")
    return merge_inner(merge_inner(out, users, "user_id"), items, "item_id")


def process_data(data: dict) -> dict:
    """Enrich every table; returns {all,train,test,users,items} Frames."""
    users = enrich_users(data["users"])
    items = enrich_items(data["items"])
    enriched = {name: enrich_interactions(data[name], users, items) for name in RATING_TABLES}
    enriched["users"] = users
    enriched["items"] = items
    for name, frame in enriched.items():
        logger.debug("etl: %s enriched -> %d rows x %d cols", name, len(frame),
                     len(frame.columns))
    logger.info("etl: enrichment + joins complete")
    return enriched


def _formatter(values: list, kind: str):
    """The ``to_csv`` text of one column's values."""
    if kind == "datetime":
        midnight = all(v.hour == v.minute == v.second == v.microsecond == 0
                       for v in values if v is not None)
        fmt = "%Y-%m-%d" if midnight else "%Y-%m-%d %H:%M:%S"
        return lambda v: "" if v is None else v.strftime(fmt)
    if kind == "float":
        return lambda v: "" if v is None else repr(float(v))
    return lambda v: "" if v is None else str(v)


def save_data(frames: dict, save_dir: str = "data/ml-100k") -> None:
    for name, frame in frames.items():
        target = Path(save_dir, name + ".csv")
        cols = [[fmt(v) for v in frame.data[c]]
                for c, fmt in ((c, _formatter(frame.data[c], frame.kinds[c]))
                               for c in frame.columns)]
        with open(target, "w", encoding="utf-8", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(frame.columns)
            writer.writerows(zip(*cols))
        logger.info("etl: wrote %s (%d rows)", target, len(frame))


def local_main(args) -> None:
    if getattr(args, "synthetic", False):
        from rectpu_torch.data.synthetic import write_synthetic_dataset

        paths = write_synthetic_dataset(
            Path(args.dest, "ml-100k"),
            train_rows=args.synthetic_rows,
            test_rows=max(args.synthetic_rows // 10, 100),
        )
        logger.info("etl: synthetic dataset at %s", paths)
        return
    download_data(args.url, args.dest)
    data_dir = str(Path(args.dest, "ml-100k"))
    save_data(process_data(load_data(data_dir)), data_dir)


def gcp_main(args) -> None:
    from rectpu_torch.data.bigquery import run_gcp_pipeline

    run_gcp_pipeline(args)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Download, extract and prepare MovieLens 100k data.")
    subparsers = parser.add_subparsers(title="subcommands")

    local_parser = subparsers.add_parser("local")
    local_parser.add_argument("--url", default=DEFAULT_URL,
                              help="where to fetch the MovieLens 100k archive "
                                   "(default: %(default)s)")
    local_parser.add_argument("--dest", default="data",
                              help="directory the extracted + processed CSVs "
                                   "land in (default: %(default)s)")
    local_parser.add_argument("--log-path", default="main.log",
                              help="rotating debug-log file (default: %(default)s)")
    local_parser.add_argument("--synthetic", action="store_true",
                              help="generate schema-identical synthetic data instead of "
                                   "downloading")
    local_parser.add_argument("--synthetic-rows", type=int, default=90570,
                              help="synthetic train rows (default: %(default)s)")
    local_parser.set_defaults(main=local_main)

    gcp_parser = subparsers.add_parser("gcp", help="BigQuery pipeline")
    gcp_parser.add_argument("--url", default=DEFAULT_URL)
    gcp_parser.add_argument("--dest", default="data")
    gcp_parser.add_argument("--dataset", default="ml_100k",
                            help="BigQuery dataset that receives the raw + "
                                 "enriched tables")
    gcp_parser.add_argument("--gcs-bucket", default="recommender-tensorflow",
                            help="GCS bucket the processed CSV extracts are "
                                 "written to")
    gcp_parser.add_argument("--credentials", default="credentials.json",
                            help="service-account key file used to build the "
                                 "BigQuery client")
    gcp_parser.add_argument("--log-path", default="main.log")
    gcp_parser.set_defaults(main=gcp_main)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not hasattr(args, "main"):
        build_parser().error("a subcommand is required: local | gcp")
    log = get_logger(__name__, log_path=args.log_path, console=True)
    log.debug("etl: invoked with %s", vars(args))
    args.main(args)


if __name__ == "__main__":
    main()
