"""The GCP/BigQuery ETL variant: the port of ``rectpu/data/bigquery.py``.

Raw tables -> BigQuery -> SQL enrichment -> GCS: the same pipeline shape as
rectpu's (upload, enrich with SQL, extract CSVs), and the same generated
enrichment SQL, byte for byte, composed from the shared schema constants of
``data/ml_100k.py`` (every enriched table name comes from one
``_enriched_name``, so rectpu's fix of the reference's join names holds).

One difference: rectpu uploads each raw table as a pandas DataFrame
(``load_table_from_dataframe``). The port needs no pandas, so it uploads
the ``Frame`` that ``ml_100k.load_data`` parses as JSON rows
(``load_table_from_json``) with an explicit schema from the Frame's column
kinds, the BigQuery types of the dtypes that pandas gives the same raw
files (int64 -> INTEGER, float64 -> FLOAT, object -> STRING). A missing
value goes as null. The table, the row count and the write disposition
(WRITE_TRUNCATE) are rectpu's.

Every GCP import is lazy, so the package works without cloud libraries; a
client can be injected (``run_gcp_pipeline(args, client)``), as the tests
inject a recording stub.
"""

from __future__ import annotations

from pathlib import Path

from rectpu_torch.data.ml_100k import GENRE_FLAGS, RATING_COLUMNS, RATING_TABLES, RAW_TABLES
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ZIPCODE_PREFIX_WIDTHS = (1, 2, 3)
_RELEASE_DATE_EXPR = "PARSE_DATE('%d-%b-%Y', release)"
_ITEM_BASE_COLUMNS = ("item_id", "title", "release", "video_release", "imdb")
_TIMESTAMP_FIELDS = ("YEAR", "MONTH", "DAY", "ISOWEEK", "DAYOFWEEK")
# a Frame column's kind -> the BigQuery type of the dtype pandas reads it as
BIGQUERY_TYPES = {"int": "INTEGER", "float": "FLOAT", "str": "STRING"}


def _enriched_name(table: str) -> str:
    return table + "_full"


def _select(exprs, source: str, where: str | None = None) -> str:
    sql = "SELECT " + ", ".join(exprs) + " FROM " + source
    if where:
        sql += " WHERE " + where
    return sql


def users_enrichment_sql(dataset: str) -> str:
    """Raw user attributes plus the zipcode prefix ladder (region granularity)."""
    exprs = list(RAW_TABLES["users"].columns)
    exprs += [
        f"SUBSTR(zipcode, 0, {width}) AS zipcode{width}"
        for width in _ZIPCODE_PREFIX_WIDTHS
    ]
    return _select(exprs, f"{dataset}.users")


def items_enrichment_sql(dataset: str) -> str:
    """Item attributes + genre flags + parsed release date/year; the
    placeholder 'unknown' title row is dropped."""
    exprs = list(_ITEM_BASE_COLUMNS) + list(GENRE_FLAGS)
    exprs += [
        f"{_RELEASE_DATE_EXPR} AS release_date",
        f"EXTRACT(YEAR FROM {_RELEASE_DATE_EXPR}) AS release_year",
    ]
    return _select(exprs, f"{dataset}.items", where="title != 'unknown'")


def context_enrichment_sql(dataset: str, table: str) -> str:
    """Rating log + calendar fields from the unix timestamp, joined against
    the enriched user and item tables."""
    ts = "TIMESTAMP_SECONDS(timestamp)"
    exprs = list(RATING_COLUMNS)
    exprs.append(f"{ts} AS datetime")
    exprs += [f"EXTRACT({field} FROM {ts}) AS {alias}" for field, alias in zip(
        _TIMESTAMP_FIELDS, ("year", "month", "day", "week", "dayofweek"))]
    # joined user attributes (everything but the join key)
    exprs += [c for c in RAW_TABLES["users"].columns if c != "user_id"]
    exprs += [f"zipcode{width}" for width in _ZIPCODE_PREFIX_WIDTHS]
    # joined item attributes (everything but the join key)
    exprs += [c for c in _ITEM_BASE_COLUMNS if c != "item_id"]
    exprs += list(GENRE_FLAGS)
    exprs += ["release_date", "release_year"]
    return (
        _select(exprs, f"{dataset}.{table}")
        + f" JOIN {dataset}.{_enriched_name('users')} USING (user_id)"
        + f" JOIN {dataset}.{_enriched_name('items')} USING (item_id)"
    )


def get_credentials(credentials_path: str):
    from google.oauth2 import service_account

    return service_account.Credentials.from_service_account_file(credentials_path)


def get_bigquery_client(credentials_path: str = "credentials.json"):
    """Create a BigQuery client, from a service-account json when present."""
    from google.cloud import bigquery

    if Path(credentials_path).exists():
        credentials = get_credentials(credentials_path)
        return bigquery.Client(project=credentials.project_id, credentials=credentials)
    return bigquery.Client()


def frame_schema(frame) -> list:
    """[(column, BigQuery type)] of a ``Frame``, in column order."""
    return [(name, BIGQUERY_TYPES[frame.kinds[name]]) for name in frame.columns]


def frame_to_bigquery(frame, table_name: str, dataset: str, client):
    """Load a ``Frame`` into <dataset>.<table_name> (WRITE_TRUNCATE) as JSON
    rows with the schema of its column kinds."""
    from google.cloud import bigquery

    dataset_ref = client.dataset(dataset)
    client.create_dataset(dataset_ref, exists_ok=True)
    schema = [bigquery.SchemaField(name, kind) for name, kind in frame_schema(frame)]
    job_config = bigquery.LoadJobConfig(write_disposition="WRITE_TRUNCATE", schema=schema)
    columns = frame.columns
    rows = [dict(zip(columns, values)) for values in zip(*(frame.data[c] for c in columns))]
    job = client.load_table_from_json(rows, dataset_ref.table(table_name), job_config=job_config)
    job.result()
    logger.info("bigquery: loaded %s.%s (%d rows)", dataset, table_name, len(frame))


def bigquery_to_table(query: str, table_name: str, dataset: str, client):
    """Materialize a query into <dataset>.<table_name>."""
    from google.cloud import bigquery

    job_config = bigquery.QueryJobConfig(
        destination=client.dataset(dataset).table(table_name),
        write_disposition="WRITE_TRUNCATE",
    )
    job = client.query(query, job_config=job_config)
    job.result()
    logger.info("bigquery: materialized %s.%s", dataset, table_name)


def bigquery_to_gcs(table_name: str, dataset: str, path: str, bucket: str, client):
    """Extract <dataset>.<table_name> to gs://<bucket>/<path>."""
    destination_uri = f"gs://{bucket}/{path}"
    table_ref = client.dataset(dataset).table(table_name)
    job = client.extract_table(table_ref, destination_uri)
    job.result()
    logger.info("bigquery: extracted %s -> %s", table_name, destination_uri)


def bigquery_process_data(dataset: str, client) -> None:
    """Run the generated enrichment SQL: users, items, then each rating log."""
    bigquery_to_table(users_enrichment_sql(dataset), _enriched_name("users"), dataset, client)
    bigquery_to_table(items_enrichment_sql(dataset), _enriched_name("items"), dataset, client)
    for table in RATING_TABLES:
        bigquery_to_table(
            context_enrichment_sql(dataset, table), _enriched_name(table), dataset, client
        )


def run_gcp_pipeline(args, client=None) -> None:
    """download -> BigQuery upload -> SQL enrichment -> GCS export.

    ``client`` is injectable for tests; by default one is built from
    ``args.credentials``.
    """
    from rectpu_torch.data.ml_100k import download_data, load_data

    download_data(args.url, args.dest)
    data = load_data(str(Path(args.dest, "ml-100k")))

    if client is None:
        client = get_bigquery_client(args.credentials)
    for name, frame in data.items():
        frame_to_bigquery(frame, name, args.dataset, client)
    bigquery_process_data(args.dataset, client)
    for name in data:
        path = f"{args.dest}/ml-100k/{name}.csv"
        bigquery_to_gcs(_enriched_name(name), args.dataset, path, args.gcs_bucket, client)
