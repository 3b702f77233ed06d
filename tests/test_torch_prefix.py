"""The PyTorch port's shared-prefix (split) decode against the JAX package.

- ``prefix_attention_carry`` (port; on the CPU its plain version)
  against the reference's ``prefix_attention_carry`` and
  ``prefix_attention_carry_pallas`` in interpret mode, with the
  reference's block-diagonal ``acc0`` converted to per head: rows
  outside the group, padding pages (page 0), windows that cut into or
  past the prefix; float32, 2e-5 (summation order only).
- ``paged_decode_attention`` with the carry (skip the shared pages,
  start from the injected carry) against the reference kernel in
  interpret mode with the same carry, and against the port's plain
  decode over the full table; 2e-5.
- The engine on ``tiny-dense`` with a 24-token shared head (3 pages of
  8) and ``prefix_split=True``: greedy token-identical to the JAX
  engine (whose plain path ignores the groups and computes the same
  function) and to the port with the split off, with a row-seeded row
  so that both the single-step and the fused-window decode run with
  prefix groups; the prefix-carry op must have run.

The ``cuda``-marked test holds the carry kernel and the decode kernel's
carry option against the plain versions on the card (bfloat16:
atol = rtol = 2e-2) and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jt
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.ops.pallas_paged import paged_decode_attention as jax_paged_decode
from sutro_tpu.ops.pallas_paged import prefix_attention_carry as jax_carry
from sutro_tpu.ops.pallas_paged import prefix_attention_carry_pallas as jax_carry_pallas
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.ops import attention
from sutro_tpu_torch.ops import paged_decode as pd
from sutro_tpu_torch.ops import prefix_carry as pc

TOL = 2e-5
LOGP_TOL = 1e-4
CUDA_TOL = 2e-2
B, NH, KVH, Dh, PS, MP, NP = 4, 4, 2, 16, 8, 6, 40
G = NH // KVH
N_PFX = 3  # shared pages [1, 2, 3]: 24 prefix tokens


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)  # a writable copy


def _per_head(acc_bd):
    """The reference's block-diagonal [B, NH, KVH*Dh] acc -> [B, NH, Dh]."""
    a = np.asarray(acc_bd).reshape(B, NH, KVH, Dh)
    return a[:, np.arange(NH), np.arange(NH) // G]


def _case(rng):
    """Rows 0..2 share prefix pages [1, 2, 3] at their table head; row 3
    is outside the group."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    table = np.zeros((B, MP), np.int32)
    nxt = 4
    for b in range(B):
        n_own = MP - N_PFX if b < 3 else MP
        if b < 3:
            table[b, :N_PFX] = [1, 2, 3]
        table[b, MP - n_own:] = np.arange(nxt, nxt + n_own)
        nxt += n_own
    return dict(
        q=f(B, NH, Dh), k_cur=f(B, KVH, Dh), v_cur=f(B, KVH, Dh),
        k_pages=f(NP, PS, KVH * Dh), v_pages=f(NP, PS, KVH * Dh), table=table,
        past=np.array([N_PFX * PS + 5, N_PFX * PS + 11, N_PFX * PS + 2, 17], np.int32),
        pfx_len=np.array([N_PFX * PS] * 3 + [0], np.int32),
        pfx_cnt=np.array([N_PFX] * 3 + [0], np.int32),
        win_k=f(B, 4, KVH * Dh), win_v=f(B, 4, KVH * Dh),
    )


@pytest.mark.parametrize("reference", ["plain", "pallas_interpret"])
@pytest.mark.parametrize("window", [0, 7, 2])
@pytest.mark.parametrize("padded", [False, True])
def test_prefix_carry_matches_jax(reference, window, padded):
    """window=2 masks the whole prefix for every row (l == 0, acc == 0);
    ``padded`` pads the page list with the garbage page 0 to a power of
    two, which pfx_len must mask."""
    c = _case(np.random.default_rng(11))
    pages = np.array([1, 2, 3, 0] if padded else [1, 2, 3], np.int32)
    q_pos = np.array([29, 35, 26, 17], np.int32)
    fn = jax_carry if reference == "plain" else (
        lambda *a: jax_carry_pallas(*a, interpret=True))
    m_ref, l_ref, a_ref = fn(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pages"]), jnp.asarray(c["v_pages"]),
        jnp.asarray(pages), jnp.asarray(c["pfx_len"]), jnp.asarray(q_pos),
        jnp.asarray(window, jnp.int32),
    )
    m, l, a = pc.prefix_attention_carry(
        _t(c["q"]), _t(c["k_pages"]), _t(c["v_pages"]), _t(pages, torch.int32),
        _t(c["pfx_len"], torch.int32), _t(q_pos, torch.int32), window,
    )
    assert a.shape == (B, NH, Dh)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(a.numpy(), _per_head(a_ref), atol=TOL, rtol=TOL)
    # m only matters where something was in range (l > 0)
    live = np.asarray(l_ref) > 0
    np.testing.assert_allclose(m.numpy()[live], np.asarray(m_ref)[live], atol=TOL, rtol=TOL)
    assert (l.numpy()[3] == 0).all() and (a.numpy()[3] == 0).all()  # outside the group


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("W,win_len", [(0, 0), (4, 3)])
def test_paged_decode_with_carry_matches_jax(window, W, win_len):
    c = _case(np.random.default_rng(13))
    q_pos = c["past"] + win_len
    jwin = {}
    twin = {}
    if W:
        jwin = dict(win_k=jnp.asarray(c["win_k"]), win_v=jnp.asarray(c["win_v"]),
                    win_len=jnp.asarray(win_len, jnp.int32))
        twin = dict(win_k=_t(c["win_k"]), win_v=_t(c["win_v"]), win_len=win_len)
    jargs = [jnp.asarray(c[k]) for k in
             ("q", "k_pages", "v_pages", "table", "past", "k_cur", "v_cur")]
    jw = jnp.asarray(window, jnp.int32)
    m0, l0, acc0 = jax_carry(
        jargs[0], jargs[1], jargs[2], jnp.asarray([1, 2, 3], jnp.int32),
        jnp.asarray(c["pfx_len"]), jnp.asarray(q_pos), jw,
    )
    want = jax_paged_decode(
        *jargs, jw, None, interpret=True, cross_row=False,
        pfx_cnt=jnp.asarray(c["pfx_cnt"]), m0=m0, l0=l0, acc0=acc0, **jwin,
    )
    targs = [_t(c["q"]), _t(c["k_pages"]), _t(c["v_pages"]), _t(c["table"], torch.int32),
             _t(c["past"], torch.int32), _t(c["k_cur"]), _t(c["v_cur"])]
    tm, tl, ta = pc.prefix_attention_carry(
        targs[0], targs[1], targs[2], _t([1, 2, 3], torch.int32),
        _t(c["pfx_len"], torch.int32), _t(q_pos, torch.int32), window,
    )
    got = pd.paged_decode_attention(
        *targs, window, pfx_cnt=_t(c["pfx_cnt"], torch.int32), m0=tm, l0=tl, acc0=ta,
        **twin,
    )
    full = pd.paged_decode_attention(*targs, window, **twin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL, rtol=TOL)


def test_chunk_attention_with_groups_matches_full_table():
    """Two disjoint groups: their carries combine by max/sum/sum."""
    c = _case(np.random.default_rng(17))
    table = c["table"].copy()
    table[3, :2] = [30, 31]  # row 3 heads a second group on pages [30, 31]
    groups = (
        (_t([1, 2, 3], torch.int32), _t(c["pfx_len"], torch.int32)),
        (_t([30, 31], torch.int32), _t([0, 0, 0, 2 * PS], torch.int32)),
    )
    past = c["past"].copy()
    past[3] = 2 * PS + 9
    kw = dict(
        positions=_t(past[:, None], torch.int32), valid_len=torch.ones(B, dtype=torch.int32),
        past_k_pages=_t(c["k_pages"]), past_v_pages=_t(c["v_pages"]),
        page_table=_t(table, torch.int32), past_len=_t(past, torch.int32),
    )
    q, k, v = _t(c["q"][:, None]), _t(c["k_cur"][:, None]), _t(c["v_cur"][:, None])
    got = attention.chunk_attention(q, k, v, pfx_groups=groups, **kw)
    want = attention.chunk_attention(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the engine with prefix_split on tiny-dense
# ---------------------------------------------------------------------------

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", prefill_chunk=16,
)
SEEDED = 4  # the row-seeded row: the batch holding it decodes single steps


@pytest.fixture(scope="module")
def shared_params():
    params = jt.init_params(MCFG, jax.random.PRNGKey(3), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    return params, params_from_numpy(MCFG, tree, "cpu", torch.float32)


def _requests(sched_mod):
    """A 24-token shared head (3 pages of 8) and distinct suffixes."""
    rng = np.random.default_rng(0)
    head = rng.integers(3, 500, 24).astype(np.int32)
    out = []
    for i, n in enumerate((5, 9, 30, 13, 1, 22, 3)):
        kw = dict(temperature=0.0)
        if i == SEEDED:
            kw = dict(temperature=0.8, top_p=0.9, row_seed=77)
        out.append(sched_mod.GenRequest(
            row_id=i, prompt_ids=np.concatenate([head, rng.integers(3, 500, n)]).astype(
                np.int32), max_new_tokens=4 if i == SEEDED else 12 + i, **kw))
    return out


def _run_port(tparams, multi_step, split, monkeypatch=None):
    runner = t_runner.ModelRunner(
        MCFG, EngineConfig(**ENGINE, decode_multi_step=multi_step, prefix_split=split),
        tparams, device="cpu",
    )
    seen = {"decode_step": 0, "decode_multi_async": 0, "carry": 0}
    for name in ("decode_step", "decode_multi_async"):
        def counted(*a, _fn=getattr(runner, name), _name=name, **k):
            seen[_name] += bool(k.get("pfx"))  # calls that carried prefix groups
            return _fn(*a, **k)
        setattr(runner, name, counted)
    if monkeypatch is not None:
        real = attention.prefix_attention_carry

        def carry(*a, **k):
            seen["carry"] += 1
            return real(*a, **k)
        monkeypatch.setattr(attention, "prefix_attention_carry", carry)
    res = {}
    b = t_sched.ContinuousBatcher(runner, stop_ids=[1])
    assert b.run(_requests(t_sched), on_result=lambda r: res.__setitem__(r.row_id, r)) == \
        "completed"
    return res, seen


@pytest.mark.parametrize("multi_step", [1, 4])
def test_split_decode_matches_jax_engine(shared_params, multi_step, monkeypatch):
    """Also the regression test of the scheduler's gate: with the port's
    runner, prefix_split=True builds groups and the carry op runs."""
    jparams, tparams = shared_params
    jr = jax_runner.ModelRunner(
        MCFG, JaxEngineConfig(use_pallas=False, prefix_split=True,
                              decode_multi_step=multi_step, **ENGINE), jparams,
    )
    want = {}
    jb = jax_sched.ContinuousBatcher(jr, stop_ids=[1])
    assert jb.run(_requests(jax_sched), on_result=lambda r: want.__setitem__(r.row_id, r)) \
        == "completed"
    got, seen = _run_port(tparams, multi_step, True, monkeypatch)
    assert sorted(got) == sorted(want)
    for i in want:
        if i == SEEDED:  # the engines' random streams differ
            continue
        assert got[i].token_ids == want[i].token_ids, i
        assert got[i].finish_reason == want[i].finish_reason, i
        assert got[i].cumulative_logprob == pytest.approx(
            want[i].cumulative_logprob, abs=LOGP_TOL, rel=LOGP_TOL
        )
    assert seen["carry"] > 0 and seen["decode_step"] > 0, seen
    if multi_step > 1:
        assert seen["decode_multi_async"] > 0, seen


@pytest.mark.parametrize("multi_step", [1, 4])
def test_split_decode_matches_unsplit(shared_params, multi_step):
    _, tparams = shared_params
    split, seen = _run_port(tparams, multi_step, True)
    plain, seen_off = _run_port(tparams, multi_step, False)
    assert seen["decode_step"] > 0 and seen_off == {
        "decode_step": 0, "decode_multi_async": 0, "carry": 0}
    assert sorted(split) == sorted(plain)
    for i in plain:
        assert split[i].token_ids == plain[i].token_ids, i
        assert split[i].cumulative_logprob == pytest.approx(
            plain[i].cumulative_logprob, abs=LOGP_TOL, rel=LOGP_TOL
        )


# ---------------------------------------------------------------------------
# the CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh_", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 70])
def test_cuda_prefix_carry_and_decode_match_plain(cuda_device, Dh_, window):
    g = torch.Generator(device=cuda_device).manual_seed(Dh_ + window)
    bf = dict(device=cuda_device, dtype=torch.bfloat16, generator=g)
    Bc, NHc, KVHc, PSc, MPc, NPc, n_pfx = 24, 8, 2, 16, 12, 400, 6
    kp = torch.randn((NPc, PSc, KVHc * Dh_), **bf)
    vp = torch.randn((NPc, PSc, KVHc * Dh_), **bf)
    table = torch.zeros((Bc, MPc), dtype=torch.int32, device=cuda_device)
    pages = torch.arange(1, 1 + n_pfx, dtype=torch.int32, device=cuda_device)
    own = torch.arange(1 + n_pfx, 1 + n_pfx + Bc * MPc, dtype=torch.int32,
                       device=cuda_device).reshape(Bc, MPc)
    member = torch.arange(Bc, device=cuda_device) % 5 != 0   # every 5th row is outside
    table[:] = own
    table[member, :n_pfx] = pages
    past = torch.randint(1, MPc * PSc - 8, (Bc,), generator=g, device=cuda_device)
    past = torch.where(member, past.clamp(min=n_pfx * PSc), past).to(torch.int32)
    pfx_len = torch.where(member, n_pfx * PSc, 0).to(torch.int32)
    q = torch.randn((Bc, NHc, Dh_), **bf)
    k_cur = torch.randn((Bc, KVHc, Dh_), **bf)
    v_cur = torch.randn((Bc, KVHc, Dh_), **bf)
    padded = torch.cat([pages, torch.zeros(2, dtype=torch.int32, device=cuda_device)])
    got = pc.prefix_attention_carry(q, kp, vp, padded, pfx_len, past, window)
    want = pc.prefix_attention_carry_plain(q, kp, vp, padded, pfx_len, past, window)
    for x, y in zip(got, want):
        ok = want[1] > 0 if x.dim() == 2 else torch.ones_like(x, dtype=torch.bool)
        torch.testing.assert_close(x[ok], y[ok], atol=CUDA_TOL, rtol=CUDA_TOL)
    args = (q, kp, vp, table, past, k_cur, v_cur, window)
    out = pd.paged_decode_attention(
        *args, pfx_cnt=pfx_len // PSc, m0=got[0], l0=got[1], acc0=got[2])
    full = pd.paged_decode_plain(*args)
    torch.testing.assert_close(out.float(), full.float(), atol=CUDA_TOL, rtol=CUDA_TOL)
