"""The port's BigQuery ETL variant (``rectpu_torch/data/bigquery.py``)
against rectpu's (``rectpu/data/bigquery.py``), both against a recording
stub client, as ``tests/test_bigquery.py`` runs rectpu's: no credentials,
no cloud library (a stub ``google.cloud.bigquery`` module is installed).

  - The generated enrichment SQL: the same strings as rectpu's.
  - The pipeline on fabricated raw GroupLens files (``tests/test_torch_ml100k.py``
    ``RAW_SETS``: rectpu's ``tests/test_etl.py`` files and a set with what
    pandas' type inference decides): the same datasets created, the same
    loads (dataset, table, row count, write disposition) in the same order,
    the same queries and the same extract URIs. The port loads JSON rows
    with an explicit schema (the machine with the card has no pandas), whose
    BigQuery types are those of the dtypes of rectpu's DataFrames of the same
    files, and whose rows are those DataFrames' values (a missing value as
    null).
"""

import math
import sys
import types
from argparse import Namespace

import numpy as np
import pytest

from rectpu.data import bigquery as jax_bq
from rectpu.data.ml_100k import load_data as jax_load_data
from rectpu_torch.data import bigquery as bq
from rectpu_torch.data import ml_100k as etl
from test_torch_ml100k import RAW_SETS

PANDAS_TO_BIGQUERY = {"int64": "INTEGER", "float64": "FLOAT", "object": "STRING",
                      "str": "STRING"}


class _Job:
    def result(self):
        return None


class _TableRef:
    def __init__(self, dataset, name):
        self.dataset, self.name = dataset, name


class _DatasetRef:
    def __init__(self, name):
        self.name = name

    def table(self, table_name):
        return _TableRef(self.name, table_name)


class RecordingClient:
    """Records every BigQuery call, in order, instead of performing it."""

    def __init__(self):
        self.calls = []
        self.frames = {}  # table -> the DataFrame or JSON rows loaded, and the schema

    def dataset(self, name):
        return _DatasetRef(name)

    def create_dataset(self, ref, exists_ok=False):
        self.calls.append(("create_dataset", ref.name, exists_ok))

    def load_table_from_dataframe(self, df, table_ref, job_config=None):
        self.calls.append(("load", table_ref.dataset, table_ref.name, len(df),
                           job_config.write_disposition))
        self.frames[table_ref.name] = (df, None)
        return _Job()

    def load_table_from_json(self, rows, table_ref, job_config=None):
        self.calls.append(("load", table_ref.dataset, table_ref.name, len(rows),
                           job_config.write_disposition))
        self.frames[table_ref.name] = (rows, [(f.name, f.field_type) for f in job_config.schema])
        return _Job()

    def query(self, sql, job_config=None):
        dest = job_config.destination
        self.calls.append(("query", dest.dataset, dest.name, sql, job_config.write_disposition))
        return _Job()

    def extract_table(self, table_ref, destination_uri):
        self.calls.append(("extract", table_ref.dataset, table_ref.name, destination_uri))
        return _Job()


@pytest.fixture
def stub_bigquery(monkeypatch):
    return install_stub(monkeypatch)


def install_stub(monkeypatch):
    """A stub google.cloud.bigquery so the lazy imports resolve; its Client()
    makes a RecordingClient and keeps it in ``.clients``."""
    mod = types.ModuleType("google.cloud.bigquery")
    mod.LoadJobConfig = lambda write_disposition=None, schema=None: types.SimpleNamespace(
        write_disposition=write_disposition, schema=schema)
    mod.QueryJobConfig = lambda destination=None, write_disposition=None: types.SimpleNamespace(
        destination=destination, write_disposition=write_disposition)
    mod.SchemaField = lambda name, field_type: types.SimpleNamespace(name=name,
                                                                     field_type=field_type)
    mod.clients = []

    def client(*args, **kwargs):
        mod.clients.append(RecordingClient())
        return mod.clients[-1]

    mod.Client = client
    google = types.ModuleType("google")
    cloud = types.ModuleType("google.cloud")
    cloud.bigquery = mod
    google.cloud = cloud
    for name, m in (("google", google), ("google.cloud", cloud), ("google.cloud.bigquery", mod)):
        monkeypatch.setitem(sys.modules, name, m)
    return mod


def _raw_dir(tmp_path, raw):
    """A dest dir whose archive and README exist, so download_data fetches nothing."""
    (tmp_path / "ml-100k.zip").write_bytes(b"")
    src = tmp_path / "ml-100k"
    src.mkdir()
    (src / "README").write_text("ml-100k")
    for name, data in RAW_SETS[raw].items():
        (src / name).write_bytes(data)
    return tmp_path


@pytest.mark.parametrize("dataset", ["ds", "ml_100k"])
def test_generated_sql_is_rectpus(dataset):
    assert bq.users_enrichment_sql(dataset) == jax_bq.users_enrichment_sql(dataset)
    assert bq.items_enrichment_sql(dataset) == jax_bq.items_enrichment_sql(dataset)
    for table in etl.RATING_TABLES:
        assert bq.context_enrichment_sql(dataset, table) == \
            jax_bq.context_enrichment_sql(dataset, table)
    assert "JOIN ds.users_full" in bq.context_enrichment_sql("ds", "train")


def _value(v):
    """A DataFrame cell as the JSON row's value (NaN -> None, numpy scalar -> Python)."""
    if isinstance(v, float) and math.isnan(v):
        return None
    return v.item() if isinstance(v, np.generic) else v


@pytest.mark.parametrize("raw", list(RAW_SETS))
def test_pipeline_makes_rectpus_calls(raw, tmp_path, stub_bigquery):
    args = Namespace(url=etl.DEFAULT_URL, dest=str(_raw_dir(tmp_path, raw)), dataset="ml_100k",
                     gcs_bucket="bkt", credentials=str(tmp_path / "no-credentials.json"))
    mine, theirs = RecordingClient(), RecordingClient()
    bq.run_gcp_pipeline(args, client=mine)
    jax_bq.run_gcp_pipeline(args, client=theirs)
    assert mine.calls == theirs.calls
    assert [c[0] for c in mine.calls].count("load") == 5
    assert [c[0] for c in mine.calls].count("extract") == 5
    frames = jax_load_data(str(tmp_path / "ml-100k"))
    for name, df in frames.items():
        rows, schema = mine.frames[name]
        want = [(c, PANDAS_TO_BIGQUERY[str(df[c].dtype)]) for c in df.columns]
        assert schema == want, name
        assert rows == [{c: _value(df[c].iloc[i]) for c in df.columns} for i in range(len(df))]


def test_gcp_cli_runs_the_pipeline(tmp_path, stub_bigquery):
    """``ml_100k gcp`` (ROADMAP.md queue A16 until now) builds the client from
    the stub module (no credentials file) and runs every step."""
    dest = _raw_dir(tmp_path, "test_etl")
    etl.main(["gcp", "--dest", str(dest), "--gcs-bucket", "bkt", "--credentials",
              str(tmp_path / "none.json"), "--log-path", str(tmp_path / "gcp.log")])
    (client,) = stub_bigquery.clients
    kinds = [c[0] for c in client.calls]
    assert kinds.count("load") == 5 and kinds.count("query") == 5
    uri = f"gs://bkt/{dest}/ml-100k/train.csv"
    assert ("extract", "ml_100k", "train_full", uri) in client.calls
