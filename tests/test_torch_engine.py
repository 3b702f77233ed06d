"""The PyTorch engine against the JAX engine on ``tiny-dense``.

The same float32 parameters go into the JAX engine (plain jnp path,
``use_pallas=False``) and the port on the CPU, and the same requests
through ``ContinuousBatcher``: greedy token ids and finish reasons must
be identical, and cumulative logprobs agree to 1e-4 (float32 summation
order through the stack). Prompts of several lengths include one longer
than ``prefill_chunk`` (the chunked path over paged past), and
``decode_multi_step=4`` runs the fused window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.models import transformer as t_transformer

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", decode_multi_step=4,
    prefill_chunk=16,
)
LOGP_TOL = 1e-4


@pytest.fixture(scope="module")
def shared_params():
    params = jax_transformer.init_params(MCFG, jax.random.PRNGKey(3), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    return params, params_from_numpy(MCFG, tree, "cpu", torch.float32)


def _prompts(shared: int = 0):
    """Several lengths, one longer than ``prefill_chunk``; with
    ``shared`` > 0 every row starts with the same ``shared`` tokens (the
    scheduler then prefills that prefix once and each row's suffix over
    it: T > 1 over paged past)."""
    rng = np.random.default_rng(0)
    head = rng.integers(3, 500, shared).astype(np.int32)
    return [
        np.concatenate([head, rng.integers(3, 500, n).astype(np.int32)])
        for n in (5, 9, 40, 13, 2, 27, 1)
    ]


def _run(runner_mod, sched_mod, runner, requests, stop_ids=(1,)):
    res = {}
    b = sched_mod.ContinuousBatcher(runner, stop_ids=list(stop_ids))
    state = b.run(requests, on_result=lambda r: res.__setitem__(r.row_id, r))
    assert state == "completed"
    return res


def _requests(sched_mod, shared: int = 0, **kw):
    return [
        sched_mod.GenRequest(row_id=i, prompt_ids=p, max_new_tokens=10 + i, **kw)
        for i, p in enumerate(_prompts(shared))
    ]


@pytest.mark.parametrize("multi_step,shared", [(4, 0), (1, 0), (4, 19)])
def test_greedy_matches_jax_engine(shared_params, multi_step, shared):
    jparams, tparams = shared_params
    jr = jax_runner.ModelRunner(
        MCFG, JaxEngineConfig(use_pallas=False, **{**ENGINE, "decode_multi_step": multi_step}),
        jparams,
    )
    tr = t_runner.ModelRunner(
        MCFG, EngineConfig(**{**ENGINE, "decode_multi_step": multi_step}), tparams,
        device="cpu",
    )
    want = _run(jax_runner, jax_sched, jr, _requests(jax_sched, shared, temperature=0.0))
    got = _run(t_runner, t_sched, tr, _requests(t_sched, shared, temperature=0.0))
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].token_ids == want[i].token_ids, i
        assert got[i].finish_reason == want[i].finish_reason, i
        assert got[i].input_tokens == want[i].input_tokens
        assert got[i].cumulative_logprob == pytest.approx(
            want[i].cumulative_logprob, abs=LOGP_TOL, rel=LOGP_TOL
        )


def test_sampled_and_seeded_rows_complete(shared_params):
    """Top-p and row-seeded rows (the single-step path) run to their
    token budgets; a row-seeded row's tokens do not depend on the rest
    of the batch."""
    _, tparams = shared_params
    tr = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE), tparams, device="cpu")
    reqs = _requests(t_sched, temperature=0.9, top_p=0.9)
    reqs[2].row_seed = 77
    got = _run(t_runner, t_sched, tr, reqs, stop_ids=())
    for i, r in got.items():
        assert r.finish_reason == "length" and len(r.token_ids) == 10 + i
        assert np.isfinite(r.cumulative_logprob)
    alone = _run(t_runner, t_sched, tr, [reqs[2]], stop_ids=())
    assert alone[2].token_ids == got[2].token_ids


def test_decode_step_matches_dense_forward(shared_params):
    """The runner's paged decode reproduces a full-context forward."""
    _, tparams = shared_params
    ecfg = EngineConfig(**ENGINE)
    runner = t_runner.ModelRunner(MCFG, ecfg, tparams, device="cpu")
    prompt = _prompts()[2][:11]
    table = np.zeros((ecfg.max_pages_per_seq,), np.int32)
    table[:4] = [1, 2, 3, 4]
    logits = runner.prefill(prompt, table)
    nxt = int(np.argmax(logits))
    B = ecfg.decode_batch_size
    tables = np.zeros((B, ecfg.max_pages_per_seq), np.int32)
    tables[0] = table
    last = np.zeros((B,), np.int32)
    last[0] = nxt
    past = np.zeros((B,), np.int32)
    past[0] = len(prompt)
    toks, logps = runner.decode_step(
        last, past, tables, 0, np.zeros((B,), np.float32), np.ones((B,), np.float32)
    )
    full = torch.as_tensor(np.concatenate([prompt, [nxt]]).astype(np.int32))[None]
    ref, _, _ = t_transformer.forward(
        MCFG, runner.params, full, torch.arange(full.shape[1])[None],
        torch.tensor([full.shape[1]]),
    )
    assert int(toks[0]) == int(ref[0, -1].argmax())
    assert logps[0] == pytest.approx(
        float(torch.log_softmax(ref[0, -1], -1).max()), abs=1e-4
    )


def test_runner_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE))


@pytest.mark.parametrize("field,value", [("tp", 2), ("ep", 2), ("pp", 2)])
def test_runner_refuses_unported_options(shared_params, field, value):
    """Meshes run (tests/test_torch_mesh_engine.py); what stays unported
    is the mesh's data axis beside them, which raises before any rank
    process starts."""
    _, tparams = shared_params
    with pytest.raises(NotImplementedError, match="data axis"):
        t_runner.ModelRunner(
            MCFG, EngineConfig(**{**ENGINE, field: value, "dp": 2}), tparams, device="cpu"
        )


def test_pages_round_trip(shared_params):
    _, tparams = shared_params
    runner = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE), tparams, device="cpu")
    runner.cache.k_pages[:, 3] = 1.5
    runner.cache.v_pages[:, 3] = -2.0
    payload = runner.read_pages([3])
    runner.write_pages([7], payload)
    assert torch.equal(runner.cache.k_pages[:, 7], runner.cache.k_pages[:, 3])
    assert torch.equal(runner.cache.v_pages[:, 7], runner.cache.v_pages[:, 3])
    info = runner.device_info()
    assert info["device_kind"] == "cpu" and info["num_layers"] == MCFG.num_layers
