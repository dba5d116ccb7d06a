"""The port's SSD block (``repro_torch.nn.ssd``) against ``repro.nn.ssd``.

Inputs and weights come from numpy (the weights from the JAX package's
``ssd_init``, its zero and one vectors moved off their init values so
that a misplaced bias or scale shows); the JAX side runs under
``jax.jit``, as its trainer does. Two shapes: the mamba2 smoke variant's
(``headdim = d_state = 16``, S a multiple of ``chunk``) and one with P !=
N, H > 1, ``d_inner`` not a power of two and S not a multiple of
``chunk``, so a transpose of the head-dim and state axes, the padding of
the last chunk and the gated RMSNorm's mean over ``d_inner`` (the jitted
reference multiplies by ``fl(1/d_inner)``) all show.

Values agree to rtol 1e-5 with an absolute floor of 1e-5 of the largest
magnitude (float32 products sum in another order in XLA:CPU and PyTorch,
and ``silu``, ``exp`` and ``_segsum``'s difference of cumulative sums can
differ in their last bits). S decode steps from ``ssd_init_cache`` equal
one chunked scan in each package to rtol 1e-4 with the same kind of floor:
the two algorithms sum the recurrence in different orders (per step
against per chunk), over up to 64 steps.

The gradients of ``A_log`` and ``dt_bias`` agree to rtol 1e-4 (floor 1e-4
of the largest magnitude): each sums B * S * chunk terms of both signs
through ``exp(_segsum)``, and both float32 computations lie up to 3.6e-5
(``A_log``) and 5e-6 (``dt_bias``) of that magnitude from the port
evaluated in float64 (every other leaf within 7e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssd as jssd
from repro_torch.nn import ssd as tssd

RTOL = 1e-5
DECODE_RTOL = 1e-4
DECAY_RTOL = 1e-4  # the gradients of A_log and dt_bias (module docstring)
# name: (d_model, d_inner, headdim, d_state, chunk, S)
SHAPES = {
    "smoke": (128, 256, 16, 16, 32, 64),
    "p_ne_n": (96, 192, 16, 8, 32, 48),
}
B = 2


def _close(got, want, rtol=RTOL, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def _params(shape, seed=0):
    d_model, d_inner, headdim, d_state, _, _ = shape
    p, _ = jssd.ssd_init(jax.random.PRNGKey(seed), d_model, d_inner=d_inner,
                         headdim=headdim, d_state=d_state)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in p.items()}
    for name in ("conv_b", "dt_bias", "D", "norm"):
        p[name] = (p[name] + 0.1 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    return p


def _scan_inputs(shape, seed=1):
    _, d_inner, headdim, d_state, _, S = shape
    H = d_inner // headdim
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x=f(B, S, H, headdim),
        dt=rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32),
        A=-rng.uniform(1.0, 16.0, H).astype(np.float32),
        Bm=f(B, S, d_state),
        Cm=f(B, S, d_state),
    )


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(SHAPES))
def test_causal_conv_matches_jax(name):
    _, d_inner, _, d_state, _, S = SHAPES[name]
    C = d_inner + 2 * d_state
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((tssd.CONV_K, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = jax.jit(jssd._causal_conv)(xbc, w, b)
    got = tssd._causal_conv(*(torch.from_numpy(a) for a in (xbc, w, b)))
    _close(got.numpy(), want)
    # causal: the first output row sees only the first input row
    np.testing.assert_allclose(got[:, 0].numpy(), xbc[:, 0] * w[-1] + b,
                               rtol=1e-6)


def test_segsum_matches_jax():
    rng = np.random.default_rng(3)
    x = -rng.uniform(0.0, 2.0, (2, 3, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jssd._segsum)(x))
    got = tssd._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_chunked_matches_jax(name, with_h0):
    shape = SHAPES[name]
    _, d_inner, headdim, d_state, chunk, _ = shape
    inp = _scan_inputs(shape)
    if with_h0:
        inp["h0"] = np.random.default_rng(4).standard_normal(
            (B, d_inner // headdim, headdim, d_state)).astype(np.float32)
    jy, jh = jax.jit(lambda kw: jssd.ssd_scan_chunked(**kw, chunk=chunk))(inp)
    ty, th = tssd.ssd_scan_chunked(**_t(inp), chunk=chunk)
    assert tuple(ty.shape) == jy.shape and tuple(th.shape) == jh.shape
    _close(ty.numpy(), jy, msg="y")
    _close(th.numpy(), jh, msg="h_final")


def _block_kw(shape):
    _, d_inner, headdim, d_state, chunk, _ = shape
    return dict(d_inner=d_inner, headdim=headdim, d_state=d_state, chunk=chunk)


@pytest.mark.parametrize("name", list(SHAPES))
def test_block_forward_and_grads_match_jax(name):
    """``ssd_block_apply``'s output, and the gradient of ``<out, ct>`` for
    a random cotangent ``ct`` with respect to every weight and the input."""
    shape = SHAPES[name]
    d_model, S = shape[0], shape[-1]
    kw = _block_kw(shape)
    p = _params(shape)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, d_model)).astype(np.float32)

    def jloss(p, x):
        out, _ = jssd.ssd_block_apply(p, x, **kw)
        return jnp.sum(out * ct), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, x)

    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, cache = tssd.ssd_block_apply(tp, tx, **kw)
    assert cache is None
    (tout * torch.from_numpy(ct)).sum().backward()
    _close(tout.detach().numpy(), jout, msg="out")
    _close(tx.grad.numpy(), jgx, msg="grad x")
    for k in p:
        rtol = DECAY_RTOL if k in ("A_log", "dt_bias") else RTOL
        _close(tp[k].grad.numpy(), jgp[k], rtol, msg=f"grad {k}")


@pytest.mark.parametrize("name", list(SHAPES))
def test_decode_steps_equal_chunked_scan(name):
    """S steps of ``ssd_decode_step`` from a zero state equal one
    ``ssd_scan_chunked`` (y at every step and the final state), and S
    steps of ``ssd_block_apply`` from ``ssd_init_cache`` equal one call
    without a cache; in the port and, the same way, in the JAX package."""
    shape = SHAPES[name]
    d_model, d_inner, headdim, d_state, chunk, S = shape
    inp = _scan_inputs(shape)
    p = _params(shape)
    x = np.random.default_rng(6).standard_normal((B, S, d_model)).astype(
        np.float32)
    kw = _block_kw(shape)

    # the port
    t = _t(inp)
    y_scan, h_scan = tssd.ssd_scan_chunked(**t, chunk=chunk)
    h = torch.zeros_like(h_scan)
    ys = []
    for s in range(S):
        y, h = tssd.ssd_decode_step(t["x"][:, s], t["dt"][:, s], t["A"],
                                    t["Bm"][:, s], t["Cm"][:, s], h)
        ys.append(y)
    _close(torch.stack(ys, 1).numpy(), y_scan.numpy(), DECODE_RTOL, "port y")
    _close(h.numpy(), h_scan.numpy(), DECODE_RTOL, "port h")
    tp, tx = _t(p), torch.from_numpy(x)
    full, _ = tssd.ssd_block_apply(tp, tx, **kw)
    cache = tssd.ssd_init_cache(B, d_inner, headdim, d_state, "cpu")
    outs = []
    for s in range(S):
        out, cache = tssd.ssd_block_apply(tp, tx[:, s:s + 1], cache=cache, **kw)
        outs.append(out)
    _close(torch.cat(outs, 1).numpy(), full.numpy(), DECODE_RTOL, "port block")

    # the JAX package, the same way
    jy_scan, jh_scan = jax.jit(
        lambda kw_: jssd.ssd_scan_chunked(**kw_, chunk=chunk))(inp)

    def jdecode(inp):
        def body(h, s):
            y, h = jssd.ssd_decode_step(s["x"], s["dt"], inp["A"], s["Bm"],
                                        s["Cm"], h)
            return h, y
        steps = {k: jnp.moveaxis(inp[k], 1, 0) for k in ("x", "dt", "Bm", "Cm")}
        h, ys = jax.lax.scan(body, jnp.zeros_like(jh_scan), steps)
        return jnp.moveaxis(ys, 0, 1), h

    jy, jh = jax.jit(jdecode)(inp)
    _close(jy, jy_scan, DECODE_RTOL, "jax y")
    _close(jh, jh_scan, DECODE_RTOL, "jax h")

    def jblock_decode(p, x):
        def body(c, xs):
            out, c = jssd.ssd_block_apply(p, xs[:, None], cache=c, **kw)
            return c, out[:, 0]
        c0 = jssd.ssd_init_cache(B, d_inner, headdim, d_state)
        _, outs = jax.lax.scan(body, c0, jnp.moveaxis(x, 1, 0))
        return jnp.moveaxis(outs, 0, 1)

    jfull, _ = jax.jit(lambda p, x: jssd.ssd_block_apply(p, x, **kw))(p, x)
    _close(jax.jit(jblock_decode)(p, x), jfull, DECODE_RTOL, "jax block")
    _close(full.numpy(), jfull, msg="block port vs jax")


def test_init_matches_jax_shapes_and_constants():
    """``ssd_init``'s shapes, and its constant leaves (``A_log``, ``D``,
    ``dt_bias``, ``conv_b``, ``norm``) equal to the JAX package's; the
    random ones at the JAX scales."""
    d_model, d_inner, headdim, d_state = 96, 192, 16, 8
    jp, _ = jssd.ssd_init(jax.random.PRNGKey(0), d_model, d_inner=d_inner,
                          headdim=headdim, d_state=d_state)
    tp = tssd.ssd_init(torch.Generator().manual_seed(0), d_model, "cpu",
                       d_inner=d_inner, headdim=headdim, d_state=d_state)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == jp[k].shape, k
        if k not in ("in_proj", "conv_w", "out_proj"):
            _close(v.numpy(), jp[k], msg=k)
    for k, scale in (("in_proj", d_model**-0.5), ("conv_w", 0.1),
                     ("out_proj", d_inner**-0.5)):
        assert abs(float(tp[k].std()) / scale - 1) < 0.1, k
