"""Port parity for RecurrentGemma's RG-LRU block (``models/rglru.py``) on
the reduced recurrentgemma-9b with the JAX package's weights carried by
``convert``: the gates, the log-depth scan against ``lax.associative_scan``
and a plain step loop, ``apply_rglru`` and ``decode_rglru`` from a JAX
state carried mid-stream, and the cache's layout.

Tolerances, relative to the largest magnitude of the tensor compared: 1e-5
(the port's Hillis-Steele scan and XLA's odd/even associative scan combine
in other orders; the f32 matmuls sum in another order); the init's
constant leaves exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import rglru as jrg
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import rglru as trg

ARCH, B, S, TOL = "recurrentgemma-9b", 2, 37, 1e-5


def _close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def block():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jp = jax.device_get(jrg.init_rglru(jax.random.PRNGKey(0), jc,
                                       jnp.float32))
    rng = np.random.default_rng(3)   # live biases and a varied Lambda
    for key in ("conv_b", "b_a", "b_x"):
        jp[key] = 0.1 * rng.normal(size=jp[key].shape).astype(np.float32)
    jp["lam"] = rng.uniform(0.2, 1.5, jp["lam"].shape).astype(np.float32)
    return jc, tc, jp, params_from_jax(jp, device="cpu")


def test_init_rglru_tree_matches_jax():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    want = jax.device_get(jrg.init_rglru(jax.random.PRNGKey(0), jc,
                                         jnp.float32))
    got = trg.init_rglru(torch.Generator().manual_seed(0), tc,
                         torch.float32)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
    for key in ("conv_b", "b_a", "b_x", "lam"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_gates_match_jax(block):
    jc, tc, jp, tp = block
    u = np.random.default_rng(0).normal(
        size=(B, S, tc.rglru.d_rnn)).astype(np.float32)
    jla, jb = jrg._gates(jp, jc, jnp.asarray(u))
    tla, tb = trg._gates(tp, tc, torch.from_numpy(u))
    assert tla.dtype == torch.float32
    _close(tla, jla)
    _close(tb, jb)


@pytest.mark.parametrize("s", [1, 2, 5, 64])
def test_linear_scan_matches_associative_scan_and_loop(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (B, s, 6)).astype(np.float32)
    b = rng.normal(size=(B, s, 6)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = trg.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want)
    h, loop = np.zeros((B, 6), np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    _close(got, np.stack(loop, axis=1))


def test_apply_rglru_matches_jax(block):
    jc, tc, jp, tp = block
    x = np.random.default_rng(1).normal(
        size=(B, S, jc.d_model)).astype(np.float32)
    _close(trg.apply_rglru(tp, tc, torch.from_numpy(x)),
           jrg.apply_rglru(jp, jc, jnp.asarray(x)))


def test_decode_rglru_matches_jax_mid_stream(block):
    jc, tc, jp, tp = block
    xs = np.random.default_rng(2).normal(
        size=(8, B, 1, jc.d_model)).astype(np.float32)
    jcache = jrg.init_rglru_cache(jc, B, jnp.float32)
    dec = jax.jit(lambda x, c: jrg.decode_rglru(jp, jc, x, 0, c))
    for t in range(5):
        _, jcache = dec(jnp.asarray(xs[t]), jcache)
    tcache = params_from_jax(jax.device_get(jcache), device="cpu")
    for t in range(5, 8):
        jout, jcache = dec(jnp.asarray(xs[t]), jcache)
        tout, tcache = trg.decode_rglru(tp, tc, torch.from_numpy(xs[t]), t,
                                        tcache)
        _close(tout, jout)
        for key in ("h", "conv"):
            _close(tcache[key], jcache[key])


def test_rglru_cache_layout_matches_jax():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    want = jax.device_get(jrg.init_rglru_cache(jc, 3, jnp.float32))
    got = trg.init_rglru_cache(tc, 3, torch.float32)
    assert set(got) == set(want) == {"h", "conv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
