"""The port's soft deadline (``engine/softdeadline.py``) against the JAX
package's.

Each case runs in a subprocess, as the watchdog signals the main thread
and ends the interpreter: a process armed for 1 s (by ``arm`` or by
``SUTRO_SOFT_DEADLINE_S``) unwinds, runs its ``finally`` block and exits
124; a SIGTERM takes the same path; ``remaining_s`` counts down from the
armed deadline and is None unarmed; a knob that is not a number arms
nothing. Every case gives the same exit code and output for both
packages.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("sutro_tpu_torch", "sutro_tpu")


def _run(code: str, env=None, timeout=60, term_after=None):
    """(exit code, stdout) of ``code`` in a fresh interpreter."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu", **(env or {})}
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if term_after is not None:
        # wait for the child to arm before signalling it
        line = p.stdout.readline()
        assert line.strip() == "ARMED", line
        time.sleep(term_after)
        p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("how", ["arm", "env"])
def test_an_armed_process_unwinds_and_exits_124(pkg, how):
    arm = ("sd.arm(1.0, grace_s=20.0)" if how == "arm" else "sd.arm_from_env()")
    code = (
        f"from {pkg}.engine import softdeadline as sd\n"
        f"{arm}\n"
        "import time\n"
        "try:\n"
        "    time.sleep(30)\n"
        "    print('NOT REACHED')\n"
        "finally:\n"
        "    print('FINALLY', flush=True)\n"
    )
    rc, out, err = _run(code, env={"SUTRO_SOFT_DEADLINE_S": "1"} if how == "env" else None)
    assert rc == 124, err
    assert out.split() == ["FINALLY"]
    assert "deadline interrupt delivered" in err


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sigterm_takes_the_clean_path(pkg):
    code = (
        f"from {pkg}.engine import softdeadline as sd\n"
        "sd.arm(60.0)\n"
        "import time\n"
        "print('ARMED', flush=True)\n"
        "try:\n"
        "    time.sleep(30)\n"
        "finally:\n"
        "    print('FINALLY', flush=True)\n"
    )
    rc, out, err = _run(code, term_after=0.2)
    assert rc == 124, err
    assert out.split() == ["FINALLY"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_remaining_counts_down_and_a_bad_knob_arms_nothing(pkg):
    code = (
        f"from {pkg}.engine import softdeadline as sd\n"
        "import os, time\n"
        "assert sd.remaining_s() is None\n"
        "os.environ['SUTRO_SOFT_DEADLINE_S'] = 'soon'\n"
        "sd.arm_from_env()\n"
        "assert sd.remaining_s() is None and not sd._ARMED\n"
        "sd.arm(50.0)\n"
        "a = sd.remaining_s()\n"
        "time.sleep(0.2)\n"
        "b = sd.remaining_s()\n"
        "assert 49.0 < a <= 50.0 and 0.15 < a - b < 5.0, (a, b)\n"
        "sd.arm(5.0)  # first call wins\n"
        "assert sd.remaining_s() > 45.0\n"
        "print('OK')\n"
    )
    rc, out, err = _run(code)
    assert rc == 0, err
    assert out.split() == ["OK"]
