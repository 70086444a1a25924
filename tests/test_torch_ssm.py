"""``repro_torch.models.ssm`` against ``repro.models.ssm``, function by
function, on JAX's weights (f32) and inputs made with numpy from a seed.

Tolerances: rtol 1e-5 with an atol of 1e-5 x the reference's largest
magnitude (``_close``). The two packages sum the same f32 terms in other
orders: the intra-chunk SSD products contract in torch's einsum order,
and the RG-LRU scan is a doubling scan where JAX runs
``lax.associative_scan``; the convolutions, gates and steps add in JAX's
order and agree to a few ulps. Cases: sequences that cross chunks and
that pad (S = 37 at chunk 16), an initial SSD state, an initial RG-LRU
h and conv buffer, prompts shorter than the conv kernel, and each step
function chained over a sequence against the sequence form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.models import ssm as tssm

D, D_STATE, HEAD_DIM, N_GROUPS = 64, 16, 16, 2
D_RNN = 48

# JAX's functions compiled whole (eager dispatch compiles op by op)
_STATIC = ("d_state", "head_dim", "n_groups", "chunk")
j_mamba2_seq = jax.jit(jssm.mamba2_seq, static_argnames=_STATIC)
j_mamba2_step = jax.jit(jssm.mamba2_step, static_argnames=_STATIC[:3])
j_rglru_seq = jax.jit(jssm.rglru_seq)
j_rglru_step = jax.jit(jssm.rglru_step)
j_ssd_chunked = jax.jit(jssm._ssd_chunked, static_argnums=5)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def mamba():
    jp = jssm.mamba2_init(jax.random.PRNGKey(1), D, d_state=D_STATE,
                          head_dim=HEAD_DIM, n_groups=N_GROUPS,
                          dtype=jnp.float32)
    return jp, bridge._convert(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def rglru():
    jp = jssm.rglru_block_init(jax.random.PRNGKey(2), D, D_RNN,
                               dtype=jnp.float32)
    return jp, bridge._convert(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the convolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 5, 19])
def test_causal_conv1d_matches_jax(S):
    jp = jssm.conv1d_init(jax.random.PRNGKey(S), 24, 4, dtype=jnp.float32)
    jp = dict(jp, b=jnp.asarray(_x(9, 24)))
    tp = bridge._convert(jax.tree.map(np.asarray, jp), "cpu")
    x = _x(S, 2, S, 24)
    _close(tssm.causal_conv1d(tp, _t(x)),
           jssm.causal_conv1d(jp, jnp.asarray(x)))
    buf = _x(S + 1, 2, 3, 24)
    got, gbuf = tssm.causal_conv1d_step(tp, _t(x[:, 0]), _t(buf))
    want, wbuf = jssm.causal_conv1d_step(jp, jnp.asarray(x[:, 0]),
                                         jnp.asarray(buf))
    _close(got, want)
    np.testing.assert_array_equal(gbuf.numpy(), np.asarray(wbuf))


def test_conv1d_steps_chain_to_the_sequence_form():
    jp = jssm.conv1d_init(jax.random.PRNGKey(3), 24, 4, dtype=jnp.float32)
    tp = bridge._convert(jax.tree.map(np.asarray, jp), "cpu")
    x = _t(_x(4, 2, 11, 24))
    seq = tssm.causal_conv1d(tp, x)
    buf = torch.zeros((2, 3, 24))
    for t in range(11):
        y, buf = tssm.causal_conv1d_step(tp, x[:, t], buf)
        _close(y, seq[:, t].numpy())


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------


def test_mamba2_init_matches_jax_layout():
    gen = torch.Generator().manual_seed(0)
    tp = tssm.mamba2_init(gen, D, d_state=D_STATE, head_dim=HEAD_DIM,
                          n_groups=N_GROUPS, dtype=torch.float32)
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), D, d_state=D_STATE,
                          head_dim=HEAD_DIM, n_groups=N_GROUPS,
                          dtype=jnp.float32)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    bridge._check(tp, shapes)
    for k in ("D", "dt_bias"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    _close(tp["A_log"], jp["A_log"], rtol=1e-6)   # linspace's last ulp
    std = tp["in_proj"].std().item()
    assert abs(std - D ** -0.5) < 0.1 * D ** -0.5


@pytest.mark.parametrize("S,chunk,with_h0", [(32, 8, False), (48, 16, True),
                                             (16, 16, True)])
def test_ssd_chunked_matches_jax(S, chunk, with_h0):
    H, P, G, N = 4, 8, 2, 6
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(2, S, H)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = rng.normal(size=(2, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(2, S, G, N)).astype(np.float32)
    h0 = rng.normal(size=(2, H, P, N)).astype(np.float32) if with_h0 else None
    want_y, want_h = j_ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
        None if h0 is None else jnp.asarray(h0))
    got_y, got_h = tssm._ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm)),
                                     chunk, None if h0 is None else _t(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)


@pytest.mark.parametrize("S,chunk", [(32, 16), (37, 16), (5, 16), (2, 16),
                                     (1, 8)])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_seq_matches_jax(mamba, S, chunk, carried):
    """S = 32 crosses chunks; 37 pads to 48 (dt = 0 on the pad); 5 and 2
    are one short chunk (the conv cache left-padded at 2); a carried state
    supplies h0 (its conv buffer is ignored, as in JAX)."""
    jp, tp = mamba
    x = _x(S, 2, S, D)
    H = 2 * D // HEAD_DIM
    state = None
    if carried:
        state = {"ssd": _x(S + 1, 2, H, HEAD_DIM, D_STATE),
                 "conv": _x(S + 2, 2, 3, 2 * D + 2 * N_GROUPS * D_STATE)}
    kw = dict(d_state=D_STATE, head_dim=HEAD_DIM, n_groups=N_GROUPS,
              chunk=chunk)
    want, wst = j_mamba2_seq(
        jp, jnp.asarray(x), state=None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()}, **kw)
    got, gst = tssm.mamba2_seq(
        tp, _t(x), state=None if state is None else
        {k: _t(v) for k, v in state.items()}, **kw)
    _close(got, want)
    _close(gst["ssd"], wst["ssd"])
    _close(gst["conv"], wst["conv"])


def test_mamba2_steps_chain_to_jax_and_the_sequence_form(mamba):
    """A prefill of 21 tokens, then 9 steps: each step's output and state
    equal JAX's step chain, and the steps' outputs equal the sequence form
    run over all 30 tokens."""
    jp, tp = mamba
    kw = dict(d_state=D_STATE, head_dim=HEAD_DIM, n_groups=N_GROUPS)
    x = _x(7, 2, 30, D)
    full, _ = tssm.mamba2_seq(tp, _t(x), chunk=8, **kw)
    _, gst = tssm.mamba2_seq(tp, _t(x[:, :21]), chunk=8, **kw)
    _, wst = j_mamba2_seq(jp, jnp.asarray(x[:, :21]), chunk=8, **kw)
    for t in range(21, 30):
        got, gst = tssm.mamba2_step(tp, _t(x[:, t]), gst, **kw)
        want, wst = j_mamba2_step(jp, jnp.asarray(x[:, t]), wst, **kw)
        _close(got, want)
        _close(gst["ssd"], wst["ssd"])
        _close(gst["conv"], wst["conv"])
        _close(got, full[:, t].numpy(), rtol=1e-4)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_init_decays_in_range():
    gen = torch.Generator().manual_seed(0)
    tp = tssm.rglru_block_init(gen, D, D_RNN, dtype=torch.float32)
    jp = jssm.rglru_block_init(jax.random.PRNGKey(0), D, D_RNN,
                               dtype=jnp.float32)
    bridge._check(tp, jax.tree.map(lambda a: tuple(a.shape), jp))
    a = torch.exp(-tssm.RGLRU_C * torch.nn.functional.softplus(tp["lambda"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
    assert tssm.RGLRU_C == jssm.RGLRU_C


def test_rglru_gates_match_jax(rglru):
    jp, tp = rglru
    x = _x(5, 2, 13, D_RNN)
    ga, gb = tssm._rglru_gates(tp, _t(x))
    wa, wb = jssm._rglru_gates(jp, jnp.asarray(x))
    _close(ga, wa)
    _close(gb, wb)


@pytest.mark.parametrize("S", [1, 2, 3, 5, 37, 64, 100])
def test_linear_scan_matches_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = _t(rng.uniform(0.0, 1.0, size=(2, S, 7)))
    b = _t(rng.normal(size=(2, S, 7)))
    h, want = torch.zeros((2, 7)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(tssm.linear_scan(a, b), torch.stack(want, 1).numpy())


@pytest.mark.parametrize("S", [1, 2, 3, 19, 40])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_seq_matches_jax(rglru, S, carried):
    jp, tp = rglru
    x = _x(S, 2, S, D)
    state = None
    if carried:
        state = {"h": _x(S + 1, 2, D_RNN), "conv": _x(S + 2, 2, 3, D_RNN)}
    want, wst = j_rglru_seq(jp, jnp.asarray(x), None if state is None else
                               {k: jnp.asarray(v) for k, v in state.items()})
    got, gst = tssm.rglru_seq(tp, _t(x), None if state is None else
                              {k: _t(v) for k, v in state.items()})
    _close(got, want)
    _close(gst["h"], wst["h"])
    _close(gst["conv"], wst["conv"])


def test_rglru_steps_chain_to_jax_and_the_sequence_form(rglru):
    jp, tp = rglru
    x = _x(8, 2, 25, D)
    full, _ = tssm.rglru_seq(tp, _t(x))
    _, gst = tssm.rglru_seq(tp, _t(x[:, :2]))
    _, wst = j_rglru_seq(jp, jnp.asarray(x[:, :2]))
    for t in range(2, 25):
        got, gst = tssm.rglru_step(tp, _t(x[:, t]), gst)
        want, wst = j_rglru_step(jp, jnp.asarray(x[:, t]), wst)
        _close(got, want)
        _close(gst["h"], wst["h"])
        _close(got, full[:, t].numpy(), rtol=1e-4)
    # a sequence continued from a carried state equals the steps
    cont, _ = tssm.rglru_seq(tp, _t(x[:, 20:]), tssm.rglru_seq(
        tp, _t(x[:, :20]))[1])
    _close(cont, full[:, 20:].numpy(), rtol=1e-4)
