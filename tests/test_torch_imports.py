"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

- every module of ``sutro_tpu_torch``, and ``chip_smoke``, imports in a
  fresh interpreter where importing ``jax`` or ``sutro_tpu`` fails;
  ``sutro_tpu_torch.cli`` (the one module that imports ``click`` and
  ``tabulate``) is among them;
- an AST scan finds no import of either in any file of the port;
- ``chip_smoke.main()`` exits non-zero and prints no result without a
  CUDA device;
- the same holds with the packages the card's machine lacks (pandas,
  pyarrow, pydantic, tqdm, colorama, requests, polars, safetensors,
  click, tabulate) blocked too, every module but the CLI imports, and
  there a one-row job runs through ``so.infer``
  and the engine's ``job_results``, an embedding job gives its vectors,
  and a job reads its rows from a CSV dataset;
- with the same packages blocked, the server (``server.py``) answers a
  remote-backend ``Sutro`` job and a chat request, ``so.chat`` runs on
  the local gateway, and the KV tier demotes and promotes;
- with the same packages blocked, a stage graph with an ELO sink runs
  through ``so.run_graph`` on an engine with the control plane and the
  live monitor on, ``so.get_monitor`` reads the monitor and its
  ``enforcement`` section, and ``GET /monitor/stream`` streams ticks;
- with the same packages blocked, two engines behind the port's fleet
  router take a routed job (its progress relayed as NDJSON), a routed
  chat streams, the SDK's fleet getters answer, a captured record
  replays, and a job traced under ``profile_dir`` writes its trace;
- no file of the port imports ``requests``, and no file but ``cli.py``
  imports ``click`` or ``tabulate``;
- an engine with ``SUTRO_DP_WORLD=2`` in its environment builds (a
  data-parallel rank), where the port once refused it.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sutro_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sutro_tpu")
# not installed on the card's machine: the port reaches them only inside
# the functions that need them
ABSENT_ON_CARD = ("pandas", "pyarrow", "pydantic", "tqdm", "colorama", "requests",
                  "polars", "safetensors", "click", "tabulate")
# the one module that imports click and tabulate (at module level, as the
# JAX package's CLI does)
CLI = "sutro_tpu_torch.cli"
# the kernel modules and the modules around them, imported by name
MODULES = (
    "sutro_tpu_torch.ops.cuda_build",
    "sutro_tpu_torch.ops.paged_decode",
    "sutro_tpu_torch.ops.kv_write",
    "sutro_tpu_torch.ops.flash_prefill",
    "sutro_tpu_torch.ops.prefix_carry",
    "sutro_tpu_torch.ops.grouped_matmul",
    "sutro_tpu_torch.ops.moe",
    "sutro_tpu_torch.ops.quant",
    "sutro_tpu_torch.ops.attention",
    "sutro_tpu_torch.models.transformer",
    "sutro_tpu_torch.engine.runner",
    "sutro_tpu_torch.engine.scheduler",
    "sutro_tpu_torch.engine.weights",
    "sutro_tpu_torch.engine.stepprofile",
    "sutro_tpu_torch.engine.constrain.nfa",
    "sutro_tpu_torch.engine.constrain.regex",
    "sutro_tpu_torch.engine.constrain.schema",
    "sutro_tpu_torch.engine.constrain.fsm",
    "sutro_tpu_torch.engine.constrain.cpp",
    "sutro_tpu_torch.interfaces",
    "sutro_tpu_torch.validation",
    "sutro_tpu_torch.common",
    "sutro_tpu_torch.sdk",
    "sutro_tpu_torch.templates.classification",
    "sutro_tpu_torch.engine.stageframes",
    "sutro_tpu_torch.engine.metrics",
    "sutro_tpu_torch.engine.jobstore",
    "sutro_tpu_torch.engine.api",
    "sutro_tpu_torch.engine.datasets",
    "sutro_tpu_torch.engine.roofline",
    "sutro_tpu_torch.telemetry.traceexport",
    "sutro_tpu_torch.telemetry.doctor",
    "sutro_tpu_torch.observability",
    "sutro_tpu_torch.templates.embed",
    "sutro_tpu_torch.templates.evals",
    "sutro_tpu_torch.engine.prefixstore",
    "sutro_tpu_torch.engine.kvtier",
    "sutro_tpu_torch.serving.openai",
    "sutro_tpu_torch.serving.channel",
    "sutro_tpu_torch.serving.gateway",
    "sutro_tpu_torch.fleet.frames",
    "sutro_tpu_torch.server",
    "sutro_tpu_torch.engine.softdeadline",
    "sutro_tpu_torch.engine.control",
    "sutro_tpu_torch.engine.stagegraph",
    "sutro_tpu_torch.telemetry.monitor",
    "sutro_tpu_torch.engine.profiling",
    "sutro_tpu_torch.fleet.membership",
    "sutro_tpu_torch.fleet.health",
    "sutro_tpu_torch.fleet.affinity",
    "sutro_tpu_torch.fleet.obs",
    "sutro_tpu_torch.fleet.replay",
    "sutro_tpu_torch.fleet.router",
    "sutro_tpu_torch.engine.dphost",
    "sutro_tpu_torch.telemetry.distributed",
)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _import_all_code(blocked) -> str:
    """Import every module of the port (the CLI only where ``click`` is
    not blocked) and ``chip_smoke``; print the names imported."""
    skip = (CLI,) if "click" in blocked else ()
    return (
        "import sys, pkgutil, importlib\n"
        f"for m in {tuple(blocked)!r}:\n"
        "    sys.modules[m] = None\n"
        "import sutro_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "sutro_tpu_torch.__path__, 'sutro_tpu_torch.')]\n"
        f"names += [n for n in {MODULES!r} if n not in names]\n"
        f"names = [n for n in names if n not in {skip!r}]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names), " + repr(CLI) + " in names)\n"
    )


def test_port_imports_with_jax_and_reference_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", _import_all_code(FORBIDDEN)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, cli = out.stdout.split()
    assert int(n) >= 24 and cli == "True"


def test_port_imports_and_runs_a_job_without_the_card_machines_missing_packages(tmp_path):
    code = _import_all_code(FORBIDDEN + ABSENT_ON_CARD) + (
        "from sutro_tpu_torch.engine.api import get_engine\n"
        "from sutro_tpu_torch.engine.config import EngineConfig\n"
        "eng = get_engine(EngineConfig(kv_page_size=8, max_pages_per_seq=8,\n"
        "    decode_batch_size=2, max_model_len=64, param_dtype='float32'), device='cpu')\n"
        "import sutro_tpu_torch as so\n"
        "jid = so.infer(['one row'], model='tiny-dense', stay_attached=False,\n"
        "    sampling_params={'temperature': 0.0, 'max_new_tokens': 4})\n"
        "assert so.await_job_completion(jid, obtain_results=False) == jid\n"
        "assert so.Sutro().engine is eng\n"
        "res = eng.job_results(jid, include_cumulative_logprobs=True)\n"
        "assert len(res['outputs']) == 1 and res['gen_tokens'][0] >= 1, res\n"
        "jid = so.infer(['an embedding row', 'and another'], model='tiny-emb',\n"
        "    stay_attached=False)\n"
        "assert so.await_job_completion(jid, obtain_results=False) == jid\n"
        "vecs = eng.job_results(jid)['outputs']\n"
        "assert len(vecs) == 2 and len(vecs[0]) == 128, vecs\n"
        "import os\n"
        "csv_path = os.path.join(os.environ['SUTRO_HOME'], 'rows.csv')\n"
        "open(csv_path, 'w').write('id,text\\n1,first row\\n2,second row\\n')\n"
        "ds = so.create_dataset()\n"
        "so.upload_to_dataset(ds, csv_path, verbose=False)\n"
        "jid = so.infer(ds, column='text', model='tiny-dense', stay_attached=False,\n"
        "    sampling_params={'temperature': 0.0, 'max_new_tokens': 2})\n"
        "assert so.await_job_completion(jid, obtain_results=False) == jid\n"
        "assert eng.job_results(jid, include_inputs=True)['inputs'] == ['first row', 'second row']\n"
        "assert eng.close()\n"
        "print('JOB_OK', eng.job_status(jid))\n"
        "for m in " + repr(ABSENT_ON_CARD) + ":\n"
        "    assert sys.modules[m] is None, m\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "SUTRO_HOME": str(tmp_path / "home")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "JOB_OK SUCCEEDED" in out.stdout
    assert (tmp_path / "home" / "jobs").is_dir()


def test_serving_and_the_remote_sdk_run_without_the_card_machines_missing_packages(tmp_path):
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN + ABSENT_ON_CARD!r}:\n"
        "    sys.modules[m] = None\n"
        "from sutro_tpu_torch.engine.api import get_engine\n"
        "from sutro_tpu_torch.engine.config import EngineConfig\n"
        "from sutro_tpu_torch.server import _graceful_shutdown, start_server_thread\n"
        "from sutro_tpu_torch.sdk import Sutro\n"
        "eng = get_engine(EngineConfig(kv_page_size=8, max_pages_per_seq=8,\n"
        "    decode_batch_size=2, max_model_len=64, param_dtype='float32',\n"
        "    interactive_slots=1, kv_tiers=True), device='cpu')\n"
        "srv, thread, url = start_server_thread(eng)\n"
        "c = Sutro(backend='remote', base_url=url)\n"
        "jid = c.infer(['one row'], model='tiny-dense', stay_attached=False,\n"
        "    sampling_params={'temperature': 0.0, 'max_new_tokens': 3})\n"
        "ups = [u for u in c._iter_progress(jid) if u['update_type'] == 'progress']\n"
        "assert c.get_job_status(jid) == 'SUCCEEDED' and ups[-1]['result'] == 1, ups\n"
        "out = c.chat('hello', model='tiny-dense', max_tokens=3, temperature=0.0)\n"
        "assert out['object'] == 'chat.completion', out\n"
        "import sutro_tpu_torch as so\n"
        "chunks = list(so.chat('hi', model='tiny-dense', stream=True, max_tokens=3,\n"
        "    session_id='s', system_prompt='You are a bot with a system prompt.'))\n"
        "assert chunks[-1]['choices'][0]['finish_reason'], chunks\n"
        "assert eng.gateway.checkpoint_idle(0.0) == 1\n"
        "so.chat('again', model='tiny-dense', max_tokens=3, session_id='s')\n"
        "tier = eng._kv_tiers['tiny-dense']\n"
        "assert tier.drain(10) and tier.op_census()['promotes'] >= 1, tier.op_census()\n"
        "_graceful_shutdown(eng, srv, 10)\n"
        "thread.join(30)\n"
        "assert eng.close() and not thread.is_alive()\n"
        "for m in " + repr(ABSENT_ON_CARD) + ":\n"
        "    assert sys.modules[m] is None, m\n"
        "print('SERVE_OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "SUTRO_HOME": str(tmp_path / "home")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "SERVE_OK" in out.stdout


def test_stage_graphs_control_and_monitor_run_without_the_card_machines_missing_packages(
        tmp_path):
    code = (
        "import sys, json\n"
        f"for m in {FORBIDDEN + ABSENT_ON_CARD!r}:\n"
        "    sys.modules[m] = None\n"
        "from sutro_tpu_torch.engine.api import get_engine\n"
        "from sutro_tpu_torch.engine.config import EngineConfig\n"
        "from sutro_tpu_torch.server import start_server_thread\n"
        "eng = get_engine(EngineConfig(kv_page_size=8, max_pages_per_seq=16,\n"
        "    decode_batch_size=2, max_model_len=128, param_dtype='float32',\n"
        "    control='rows=100,wait=0.5'), device='cpu')\n"
        "import sutro_tpu_torch as so\n"
        "stages = [{'name': 'gen', 'kind': 'map', 'sampling_params': {'max_new_tokens': 4}},\n"
        "    {'name': 'pairs', 'kind': 'pair', 'after': ['gen']},\n"
        "    {'name': 'judge', 'kind': 'map', 'after': ['pairs'],\n"
        "     'sampling_params': {'max_new_tokens': 2}},\n"
        "    {'name': 'elo', 'kind': 'elo', 'after': ['judge']}]\n"
        "jid = so.run_graph(['a', 'b', 'c'], stages=stages, model='tiny-dense',\n"
        "    stay_attached=False, tenant='acme', sampling_params={'temperature': 0.0})\n"
        "assert so.await_job_completion(jid, obtain_results=False) == jid\n"
        "state = eng.get_job(jid)['stages_state']\n"
        "assert all(v['status'] == 'succeeded' for v in state.values()), state\n"
        "assert state['judge']['rows_done'] == 3, state\n"
        "doc = so.get_monitor()\n"
        "assert doc['enabled'] and doc['enforcement']['buckets']['acme/p0'], doc\n"
        "srv, thread, url = start_server_thread(eng)\n"
        "from urllib.request import urlopen\n"
        "body = urlopen(url + '/monitor/stream?ticks=1', timeout=30).read().decode()\n"
        "assert [json.loads(x)['t'] for x in body.splitlines()] == ['tick', 'end'], body\n"
        "srv.shutdown()\n"
        "assert eng.close()\n"
        "for m in " + repr(ABSENT_ON_CARD) + ":\n"
        "    assert sys.modules[m] is None, m\n"
        "print('GRAPH_OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "SUTRO_HOME": str(tmp_path / "home"),
           "SUTRO_MONITOR": "1", "SUTRO_MONITOR_INTERVAL": "0.1"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "GRAPH_OK" in out.stdout


def test_the_fleet_routes_without_the_card_machines_missing_packages(tmp_path):
    code = (
        "import sys, json, os\n"
        f"for m in {FORBIDDEN + ABSENT_ON_CARD!r}:\n"
        "    sys.modules[m] = None\n"
        "from sutro_tpu_torch.engine.api import LocalEngine\n"
        "from sutro_tpu_torch.engine.config import EngineConfig\n"
        "from sutro_tpu_torch.server import start_server_thread\n"
        "from sutro_tpu_torch.sdk import Sutro\n"
        "from sutro_tpu_torch import fleet\n"
        "from sutro_tpu_torch.fleet import replay\n"
        "cfg = dict(kv_page_size=8, max_pages_per_seq=8, decode_batch_size=2,\n"
        "    max_model_len=64, param_dtype='float32', interactive_slots=1)\n"
        "prof = os.path.join(os.environ['SUTRO_HOME'], 'prof')\n"
        "engs = [LocalEngine(EngineConfig(profile_dir=prof, **cfg), device='cpu'),\n"
        "        LocalEngine(EngineConfig(**cfg), device='cpu')]\n"
        "srvs = [start_server_thread(e) for e in engs]\n"
        "router, fsrv, _, furl = fleet.start_fleet_thread([s[2] for s in srvs],\n"
        "    probe_interval=0.1)\n"
        "import time\n"
        "t0 = time.monotonic()\n"
        "while router.membership.snapshot()['n_healthy'] != 2:\n"
        "    assert time.monotonic() - t0 < 30\n"
        "    time.sleep(0.05)\n"
        "c = Sutro(backend='fleet', base_url=furl)\n"
        "jid = c.infer(['one row'], model='tiny-dense', stay_attached=False,\n"
        "    sampling_params={'temperature': 0.0, 'max_new_tokens': 3})\n"
        "assert router.job_owner(jid) == 'r0'\n"
        "ups = [u for u in c._iter_progress(jid) if u['update_type'] == 'progress']\n"
        "assert c.get_job_status(jid) == 'SUCCEEDED' and ups[-1]['result'] == 1, ups\n"
        "res = c._remote_json('post', 'job-results', json={'job_id': jid})['results']\n"
        "assert len(res['outputs']) == 1, res\n"
        "t0 = time.monotonic()\n"
        "while not os.path.exists(os.path.join(prof, jid, 'trace.json')):\n"
        "    assert time.monotonic() - t0 < 30\n"
        "    time.sleep(0.05)\n"
        "chunks = list(c.chat('hi', model='tiny-dense', stream=True, max_tokens=3))\n"
        "assert chunks[-1]['choices'][0]['finish_reason'], chunks\n"
        "assert c.get_fleet()['n_healthy'] == 2\n"
        "recs = c.get_replay_log()\n"
        "assert len(recs) == 1 and recs[0]['kind'] == 'chat', recs\n"
        "out = replay.replay(furl, recs, timeout=60)\n"
        "assert out['ok'] == 1, out\n"
        "router.stop(); fsrv.shutdown()\n"
        "for s, e in zip(srvs, engs):\n"
        "    s[0].shutdown()\n"
        "    assert e.close()\n"
        "for m in " + repr(ABSENT_ON_CARD) + ":\n"
        "    assert sys.modules[m] is None, m\n"
        "print('FLEET_OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "SUTRO_HOME": str(tmp_path / "home"),
           "SUTRO_MONITOR": "0"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "FLEET_OK" in out.stdout


def _imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            yield n.split(".")[0], n


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_requests(path):
    """The card's machine has no ``requests``: the remote SDK, the fleet
    router and replay speak ``urllib`` and ``http.client``."""
    for top, n in _imported_tops(path):
        assert top != "requests", f"{path}: imports {n}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_only_the_cli_imports_click_and_tabulate(path):
    """The card's machine has neither: the CLI is the one module that
    imports them, and nothing else of the port imports the CLI."""
    tops = {top for top, _ in _imported_tops(path)}
    if path == PORT / "cli.py":
        assert {"click", "tabulate"} <= tops
        return
    assert not tops & {"click", "tabulate"}, f"{path}: imports {tops & {'click', 'tabulate'}}"
    text = path.read_text()
    assert "from . import cli" not in text and "from .cli import" not in text, path


def test_an_engine_with_a_dp_world_builds(tmp_path, monkeypatch):
    """``SUTRO_DP_WORLD=2`` makes the engine a data-parallel rank; the
    port refused it at construction before ``engine/dphost.py`` came
    over. Building one binds nothing: the channel opens at a job."""
    from sutro_tpu_torch.engine.api import LocalEngine
    from sutro_tpu_torch.engine.config import EngineConfig

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    monkeypatch.setenv("SUTRO_DP_WORLD", "2")
    monkeypatch.setenv("SUTRO_DP_RANK", "1")
    monkeypatch.setenv("SUTRO_DP_COORD", "127.0.0.1:1")
    eng = LocalEngine(EngineConfig(), device="cpu")
    assert eng.close(timeout=30)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {n}"


def test_scan_covers_every_module():
    """The AST scan reads every named module's file, the int8 path's
    ``ops/quant.py`` among them."""
    files = set(_port_files())
    for name in MODULES:
        assert ROOT.joinpath(*name.split(".")).with_suffix(".py") in files, name
    assert PORT / "ops" / "quant.py" in files


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
