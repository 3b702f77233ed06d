"""graftlint in the port (``sutro_tpu_torch.analysis``) against the JAX
package's (``sutro_tpu.analysis``).

- Fixture parity: every rule fixture of ``tests/test_analysis.py`` (lock
  order, blocking calls, callbacks, reentrancy, thread hygiene, silent
  except, retry, resources, trace handles, wire, kill-switch,
  cardinality, races, stale suppression, the scheduler window) is
  written to a file and scanned by both packages' ``analyze``: the same
  ``(rule, file, line)`` findings, active and suppressed. The jit and
  Pallas fixtures are the one exception: the port's purity pass roots
  at device entry points instead (the torch-idiom fixtures below).
- The port's ``jit-host-sync`` / ``jit-nondeterminism`` on torch
  fixtures: each flagged, each clean counterpart not.
- The self-scan gate on ``sutro_tpu_torch`` exits 0 against the port's
  baseline; the wire schema does not drift; an injected lock inversion
  and a removed wire key each fail the gate.
"""

import ast
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import sutro_tpu.analysis as ref_analysis
import sutro_tpu_torch.analysis as port_analysis
from sutro_tpu_torch.analysis import core, protocol
from sutro_tpu_torch.analysis.callgraph import PackageIndex

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sutro_tpu_torch"
BASELINE = PORT / "analysis" / "baseline.json"
SCHEMA = PORT / "analysis" / "wire_schema.json"
_SCANNERS = {"scan": None, "scan_with_stale": None, "_wire_idx": "dphost.py"}


def _fixtures():
    """``{test name: [(file name, source), ...]}``: the source strings
    that the tests of tests/test_analysis.py hand to ``scan``,
    ``scan_with_stale`` or ``_wire_idx`` (directly or through a local
    name), with the file name they are scanned under."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        if "jit" in fn.name or "pallas" in fn.name:
            continue
        consts = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                consts[node.targets[0].id] = node.value.value
        found = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in _SCANNERS and node.args):
                continue
            arg = node.args[0]
            src = (arg.value if isinstance(arg, ast.Constant) else
                   consts.get(arg.id) if isinstance(arg, ast.Name) else None)
            if not isinstance(src, str):
                continue
            name = _SCANNERS[node.func.id] or "m.py"
            for kw in node.keywords:
                if kw.arg == "path" and isinstance(kw.value, ast.Constant):
                    name = Path(kw.value.value).name
            found.append((name, src))
        if found:
            out[fn.name] = found
    return out


FIXTURES = _fixtures()


def _keys(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


def test_every_fixture_family_is_collected():
    families = ("lock_order", "blocking_call", "callback", "reentrant", "thread_hygiene",
                "silent_except", "retry", "resource", "trace_ctx", "wire", "killswitch",
                "cardinality", "shared_state", "check_then_act", "stale_suppression",
                "sched")
    for fam in families:
        assert any(fam in name for name in FIXTURES), fam
    assert len(FIXTURES) >= 40


@pytest.mark.parametrize("test_name", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_package(test_name, tmp_path):
    for i, (name, src) in enumerate(FIXTURES[test_name]):
        d = tmp_path / str(i)
        d.mkdir()
        (d / name).write_text(src)
        want_active, want_supp, _ = ref_analysis.analyze([str(d)])
        got_active, got_supp, _ = port_analysis.analyze([str(d)])
        assert _keys(got_active) == _keys(want_active), (name, src)
        assert _keys(got_supp) == _keys(want_supp), (name, src)


# ------------------------------------------- the port's device roots

KERNEL_MOD = '''
import random
import time

import numpy as np
import torch

from .cuda_build import CudaKernel

KERNEL = CudaKernel("k", "k_bf16", [], replaces="x.py:1")


def _plain(x):
    return x


def _host_side(x: torch.Tensor):
    {body}


def op(x: torch.Tensor, n: int, g=None):
    if not x.is_cuda:
        return _plain(x)
    {root}
    KERNEL.launch(0)
    return x
'''

TRUNK_MOD = '''
import random
import time

import numpy as np
import torch


def _layer(x, n, g):
    {body}
    return x


def forward(cfg, params, x: torch.Tensor, n: int, g=None):
    return _layer(x, n, g)


def unrelated(x, n, g):
    {body}
'''

# (case, statement, rule): flagged inside the root (``op``) and in what
# ``forward`` reaches; the same statement in a function no root
# reaches is clean, as is each clean counterpart
DEVICE_CASES = [
    ("item", "y = x.item()", "jit-host-sync"),
    ("tolist", "y = x.tolist()", "jit-host-sync"),
    ("cpu", "y = x.cpu()", "jit-host-sync"),
    ("numpy", "y = x.numpy()", "jit-host-sync"),
    ("synchronize", "torch.cuda.synchronize()", "jit-host-sync"),
    ("np_asarray_param", "y = np.asarray(x)", "jit-host-sync"),
    ("float_param", "y = float(x)", "jit-host-sync"),
    ("wall_clock", "t = time.perf_counter()", "jit-nondeterminism"),
    ("python_random", "r = random.random()", "jit-nondeterminism"),
    ("np_global_random", "r = np.random.rand(3)", "jit-nondeterminism"),
    ("torch_randn", "r = torch.randn(3, device=x.device)", "jit-nondeterminism"),
    ("torch_multinomial", "r = torch.multinomial(x, 1)", "jit-nondeterminism"),
    ("torch_bernoulli", "r = torch.bernoulli(x)", "jit-nondeterminism"),
    ("int_host_param", "y = int(n)", None),
    ("np_asarray_host", "y = np.asarray([n])", None),
    ("torch_randn_generator", "r = torch.randn(3, generator=g)", None),
    ("torch_multinomial_generator", "r = torch.multinomial(x, 1, generator=g)", None),
    ("np_seeded", "r = np.random.default_rng(0)", None),
    ("to_device", "y = x.to(x.device)", None),
]


def _scan_modules(mods):
    idx = PackageIndex()
    for name, src in mods.items():
        idx.add_source(name.replace(".", "/") + ".py", textwrap.dedent(src), name)
    active, suppressed = core.apply_suppressions(idx, core.run_passes(idx))
    return active, suppressed


@pytest.mark.parametrize("case,stmt,rule", DEVICE_CASES, ids=[c[0] for c in DEVICE_CASES])
def test_device_roots_flag_host_syncs_and_unseeded_draws(case, stmt, rule):
    jit_rules = {"jit-host-sync", "jit-nondeterminism"}
    in_root, _ = _scan_modules({"pkg.ops.k": KERNEL_MOD.format(body="pass", root=stmt)})
    on_host, _ = _scan_modules({"pkg.ops.k": KERNEL_MOD.format(body=stmt, root="pass")})
    trunk, _ = _scan_modules({"pkg.models.transformer": TRUNK_MOD.format(body=stmt)})
    got = [f for f in in_root if f.rule in jit_rules]
    assert [f.rule for f in got] == ([rule] if rule else []), [f.render() for f in got]
    if rule:
        assert "device entry point `op`" in got[0].message
    assert not [f for f in on_host if f.rule in jit_rules]
    hits = [f for f in trunk if f.rule in jit_rules]
    assert [f.rule for f in hits] == ([rule] if rule else [])
    for f in hits:   # reached from forward, never from ``unrelated``
        assert "forward" in f.message and f.symbol.endswith(":_layer")


def test_a_plain_version_s_host_read_carries_its_pragma():
    """The plain version the wrapper runs on a CPU tensor: flagged when
    the wrapper reaches it, and suppressed by the pragma the port puts
    on such a line."""
    src = KERNEL_MOD.replace(
        "def _plain(x):\n    return x",
        "def _plain(x):\n    return x.tolist()",
    ).format(body="pass", root="pass")
    active, _ = _scan_modules({"pkg.ops.k": src})
    assert [f.rule for f in active if f.rule == "jit-host-sync"] == ["jit-host-sync"]
    src = src.replace("    return x.tolist()",
                      "    # CPU tensors only\n    # graftlint: disable=jit-host-sync\n"
                      "    return x.tolist()")
    active, suppressed = _scan_modules({"pkg.ops.k": src})
    assert not [f for f in active if f.rule == "jit-host-sync"]
    assert [f.rule for f in suppressed] == ["jit-host-sync"]


def test_the_port_s_device_roots():
    from sutro_tpu_torch.analysis import jitpure

    roots = {f.label for f, kind in jitpure._find_roots(core.build_index([str(PORT)]))
             if kind == "device"}
    assert roots == {
        "sutro_tpu_torch.models.transformer:forward",
        "sutro_tpu_torch.models.transformer:run_layers",
        "sutro_tpu_torch.ops.flash_prefill:flash_prefill",
        "sutro_tpu_torch.ops.grouped_matmul:grouped_matmul",
        "sutro_tpu_torch.ops.kv_write:kv_write",
        "sutro_tpu_torch.ops.paged_decode:paged_decode_attention",
        "sutro_tpu_torch.ops.prefix_carry:prefix_attention_carry",
    }


def test_the_rule_catalog_keeps_every_rule_id():
    assert set(core.RULES) == set(ref_analysis.RULES)


# ------------------------------------------------------- the gate


def _cli(args, cwd, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "sutro_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True, timeout=timeout,
    )


def test_the_self_scan_gate_is_green():
    res = _cli(["sutro_tpu_torch"], cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 new" in res.stdout
    baseline = core.load_baseline(BASELINE)
    ref = core.load_baseline(REPO / "sutro_tpu" / "analysis" / "baseline.json")
    # every accepted finding is one the JAX package accepts
    assert set(baseline) <= {k.replace("sutro_tpu", "sutro_tpu_torch") for k in ref}


def _copy_tree(tmp_path: Path) -> Path:
    dst = tmp_path / "sutro_tpu_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns("__pycache__", "build"))
    return dst


def test_the_wire_schema_does_not_drift(tmp_path):
    dst = _copy_tree(tmp_path)
    doc = protocol.write_schema(core.build_index([str(dst)]),
                                dst / "analysis" / "wire_schema.json")
    assert (dst / "analysis" / "wire_schema.json").read_text() == SCHEMA.read_text()
    ref = json.loads((REPO / "sutro_tpu" / "analysis" / "wire_schema.json").read_text())
    for frame, keys in ref["frames"].items():   # every frame the reference sends
        assert set(keys) <= set(doc["frames"].get(frame, ())), frame


def test_an_injected_lock_inversion_fails_the_gate(tmp_path):
    dst = _copy_tree(tmp_path)
    metrics = dst / "engine" / "metrics.py"
    metrics.write_text(metrics.read_text() + """

def _injected_a(bus, jm):
    with bus._lock:
        with jm.lock:
            pass


def _injected_b(bus, jm):
    with jm.lock:
        with bus._lock:
            pass
""")
    res = _cli(["sutro_tpu_torch", "--baseline", str(BASELINE)], cwd=tmp_path)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "lock-order" in res.stdout


def test_a_removed_wire_key_fails_the_gate(tmp_path):
    dst = _copy_tree(tmp_path)
    dp = dst / "engine" / "dphost.py"
    src = dp.read_text()
    anchor = '{"t": "reshard", "rows": sorted(rows)}'
    assert anchor in src
    dp.write_text(src.replace(anchor, '{"t": "reshard"}', 1))
    res = _cli(["sutro_tpu_torch", "--baseline", str(BASELINE)], cwd=tmp_path)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "wire-key-removed" in res.stdout and "reshard" in res.stdout
