"""Datasets and URL inputs in the port against the JAX package.

- ``DatasetStore``: create, upload (files and a directory), upload of a
  body, list (with each dataset's schema), list files, the traversal
  guard, download and ``read_rows`` give what the JAX store gives, and
  the same errors for an unknown dataset, a missing column and a CSV
  without ``column``.
- URL inputs (``_read_url_rows``): CSV, ``.csv.gz`` and parquet served
  by a local ``http.server`` on 127.0.0.1 give the JAX engine's rows,
  and the same errors; through ``submit_batch_inference`` a URL and a
  ``dataset-<id>`` input give both engines the same job inputs.
- The CSV reader: hypothesis draws tables of integer, float, boolean,
  text and empty cells, and ``common.read_csv_text`` must give the
  strings and dtypes of ``pd.read_csv`` (both ``tolist()`` and
  ``astype(str)``, the two ways the JAX package reads a column).
- In a process where pandas and pyarrow cannot be imported (the card's
  machine has neither), CSV and ``.txt`` datasets still read, and a
  parquet file raises an ``ImportError`` naming pyarrow.
"""

import csv
import functools
import gzip
import http.server
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.datasets import DatasetStore as JaxStore
from sutro_tpu_torch.common import CSV_NA_VALUES, read_csv_text
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.datasets import DatasetStore
from tests.test_torch_api import ENGINE

ROOT = Path(__file__).resolve().parent.parent
CSV_TEXT = (
    "id,text,score,flag,note\n"
    "1,hello world,1.50,True,\n"
    "2,\"a, quoted \"\"row\"\"\",1e3,false,NA\n"
    "3,,2,TRUE,x\n"
    "4,  spaced  ,-0.0,False,None\n"
    "5,007,.5,true,\n"
)


def _write_files(d: Path) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    (d / "a.csv").write_text(CSV_TEXT)
    (d / "b.txt").write_text("first line\n\n  second line\nthird\n")
    pq.write_table(pa.table({"text": ["p0", None, "p2"], "n": [1, None, 3],
                             "ok": [True, None, False]}), d / "c.parquet")
    (d / "one.csv").write_text("text\n1\n2\n\n3\n")
    return d


def _stable(meta: dict) -> dict:
    return {k: v for k, v in meta.items()
            if k not in ("dataset_id", "datetime_added", "updated_at")}


def test_dataset_store_matches_the_jax_store(tmp_path):
    src = _write_files(tmp_path / "src")
    stores = (JaxStore(tmp_path / "jax"), DatasetStore(tmp_path / "port"))
    ids = [s.create() for s in stores]
    for s, i in zip(stores, ids):
        assert i.startswith("dataset-") and s.list_files(i) == []
        assert s.upload(i, [src / "a.csv", src / "b.txt"]) == ["a.csv", "b.txt"]
    (jstore, tstore), (jid, tid) = stores, ids
    assert [_stable(m) for m in tstore.list_datasets()] == [
        _stable(m) for m in jstore.list_datasets()]
    assert tstore.list_datasets()[0]["schema"] == {
        "id": "int64", "text": "str", "score": "float64", "flag": "bool", "note": "str"}
    # (the JAX store's rows may hold NaN, which a job's submit turns
    # into "nan", as ``str(row)`` of every row)
    jrows = lambda **kw: [str(x) for x in jstore.read_rows(jid, **kw)]  # noqa: E731
    for col in ("text", "score", "flag", "note", ["id", ": ", "text"]):
        assert tstore.read_rows(tid, column=col) == jrows(column=col), col
    # a directory upload, and a body
    for s, i in zip(stores, ids):
        assert s.upload(i, [src]) == ["a.csv", "b.txt", "c.parquet", "one.csv"]
        assert s.upload_bytes(i, "../d.txt", b"from bytes\n") == "d.txt"
        with pytest.raises(ValueError, match="Invalid upload"):
            s.upload_bytes(i, ".meta.json", b"{}")
    assert tstore.list_files(tid) == jstore.list_files(jid)
    assert tstore.read_rows(tid, column="text") == jrows(column="text")
    for s, i in zip(stores, ids):
        for bad in ("../x", ".meta.json", "missing.csv"):
            with pytest.raises(FileNotFoundError):
                s.file_path(i, bad)
        out = s.download(i, "a.csv", tmp_path / f"out-{type(s).__module__}")
        assert out.read_text() == CSV_TEXT
    errors = []
    for s, i in zip(stores, ids):
        row = []
        for call in (lambda: s.read_rows("dataset-missing"), lambda: s.read_rows("nope"),
                     lambda: s.read_rows(i, column="nope"), lambda: s.read_rows(i)):
            with pytest.raises(Exception) as e:
                call()
            row.append((type(e.value), str(e.value)))
        errors.append(row)
    assert errors[1] == errors[0]


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A local HTTP server over a directory of input files."""
    d = _write_files(tmp_path_factory.mktemp("served"))
    (d / "a.csv.gz").write_bytes(gzip.compress(CSV_TEXT.encode()))
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet, directory=str(d)))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


@pytest.mark.parametrize("name,column", [
    ("a.csv", "text"), ("a.csv", "score"), ("a.csv", "note"), ("a.csv.gz", "flag"),
    ("c.parquet", "text"), ("c.parquet", "n"), ("c.parquet", "ok"), ("one.csv", None),
    ("a.csv?x=1", "id"),
])
def test_url_rows_match_the_jax_engine(served, name, column):
    url = f"{served}/{name}"
    # the JAX engine's rows may hold NaN (``astype(str)`` keeps it);
    # ``submit_batch_inference`` turns every row into ``str(row)``
    want = [str(x) for x in jax_api._read_url_rows(url, column)]
    assert api._read_url_rows(url, column) == want


def test_url_errors_match_the_jax_engine(served):
    for url, column in ((f"{served}/a.csv", None), (f"{served}/a.csv", "nope"),
                        (f"{served}/missing.csv", "text")):
        got = []
        for read in (jax_api._read_url_rows, api._read_url_rows):
            with pytest.raises(ValueError) as e:
                read(url, column)
            got.append(str(e.value).split(":")[0])
        assert got[1] == got[0], url


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-datasets")
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **ENGINE))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    yield jeng, teng
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def test_dataset_and_url_inputs_give_both_engines_the_same_rows(engines, served, tmp_path):
    src = _write_files(tmp_path / "src")
    inputs = []
    for eng in engines:
        ds = eng.datasets.create()
        eng.datasets.upload(ds, [src / "a.csv", src / "b.txt"])
        got = []
        for data, column in ((ds, "text"), (f"{served}/a.csv.gz", "score"),
                             (f"{served}/one.csv", None)):
            jid = eng.submit_batch_inference({
                "model": "tiny-dense", "inputs": data, "column": column, "dry_run": True})
            got.append(eng.jobs.read_inputs(jid))
        inputs.append(got)
        with pytest.raises(FileNotFoundError, match="Unknown dataset"):
            eng.submit_batch_inference({"model": "tiny-dense", "inputs": "dataset-none"})
    assert inputs[1] == inputs[0]
    assert inputs[1][0][:2] == ["hello world", 'a, quoted "row"']


# ---------------------------------------------------------------------------
# the CSV reader against pd.read_csv
# ---------------------------------------------------------------------------

_INT = st.integers(-(1 << 63), (1 << 63) - 1).map(str) | st.sampled_from(
    ["007", "+5", " 5", "-0", "0"])
_FLOAT = (
    st.floats(allow_nan=False, width=64).map(repr)
    | st.floats(allow_nan=False, allow_infinity=False).map(lambda f: f"{f:.6e}")
    | st.decimals(allow_nan=False, allow_infinity=False, places=8).map(str)
    | st.sampled_from(["1.50", "1e3", ".5", "5.", "inf", "-Infinity", "1E+05", " 2.5", "-0.0"])
)
_BOOL = st.sampled_from(["True", "TRUE", "true", "False", "FALSE", "false"])
_EMPTY = st.sampled_from(sorted(CSV_NA_VALUES))
_TEXT = st.text(alphabet="ab xyz,.\"'\n\t-e19", max_size=8)
_KINDS = {"int": _INT, "float": _FLOAT, "bool": _BOOL, "text": _TEXT}


@st.composite
def _tables(draw):
    kinds = draw(st.lists(st.sampled_from(sorted(_KINDS)), min_size=1, max_size=3))
    n = draw(st.integers(1, 8))
    cols = [draw(st.lists(_EMPTY | _KINDS[k] | _KINDS[k], min_size=n, max_size=n))
            for k in kinds]
    return [list(r) for r in zip(*cols)]


@settings(max_examples=300, deadline=None)
@given(_tables(), st.sampled_from(["\n", "\r\n"]))
def test_csv_cells_match_pandas(rows, newline):
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator=newline)
    w.writerow([f"c{i}" for i in range(len(rows[0]))])
    w.writerows(rows)
    text = buf.getvalue()
    try:
        df = pd.read_csv(io.StringIO(text))
    except Exception as e:   # e.g. every data line blank: no rows is fine too
        with pytest.raises(type(e)):
            read_csv_text(text)
        return
    columns, dtypes = read_csv_text(text)
    assert list(columns) == list(df.columns)
    for c in df.columns:
        assert columns[c] == [str(x) for x in df[c].tolist()], (c, text)
        assert columns[c] == [str(x) for x in df[c].astype(str).tolist()], (c, text)
        assert dtypes[c] == str(df[c].dtype), (c, text)


def test_csv_and_txt_datasets_without_pandas_or_pyarrow(tmp_path):
    src = _write_files(tmp_path / "src")
    code = (
        "import sys, json\n"
        "for m in ('pandas', 'pyarrow', 'jax', 'sutro_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from sutro_tpu_torch.engine.datasets import DatasetStore\n"
        f"s = DatasetStore({str(tmp_path / 'store')!r})\n"
        "i = s.create()\n"
        f"s.upload(i, [{str(src / 'a.csv')!r}, {str(src / 'b.txt')!r}])\n"
        "out = {'rows': s.read_rows(i, column='text'),\n"
        "       'score': s.read_rows(i, column='score'),\n"
        "       'schema': s.list_datasets()[0]['schema']}\n"
        f"s.upload(i, [{str(src / 'c.parquet')!r}])\n"
        "try:\n"
        "    s.read_rows(i, column='text')\n"
        "except ImportError as e:\n"
        "    out['parquet'] = str(e)\n"
        "print(json.dumps(out))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jstore = JaxStore(tmp_path / "jax")
    jid = jstore.create()
    jstore.upload(jid, [src / "a.csv", src / "b.txt"])
    assert out["rows"] == [str(x) for x in jstore.read_rows(jid, column="text")]
    assert out["score"] == [str(x) for x in jstore.read_rows(jid, column="score")]
    assert out["schema"] == jstore.list_datasets()[0]["schema"]
    assert "pyarrow" in out["parquet"]
