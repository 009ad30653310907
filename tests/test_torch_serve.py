"""Port parity for the serving path: ``generate`` against the JAX package's
on carried weights, chunked prefill against the token-by-token loop, a
(B,) position vector against duplicated-row references, the serve step and
the CLI on the CPU.

Ids are compared exactly.  Across the two packages one exception is
allowed, a documented near-tie: where the ids first differ, JAX's top-1 /
top-2 logit margin at that step must lie within the logit tolerance
(NEAR_TIE = 1e-5 of the largest logit magnitude, the decode-step
tolerance of ``test_torch_decode.py``); past that step the two sequences
continue from different tokens and are not compared.  Within the port,
ids and logits are compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.serve import generate as j_generate
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.transformer import Model

NEAR_TIE = 1e-5


def assert_ids_match_jax(got, want, jm, jp, vocab, p_len):
    """``got`` (port) and ``want`` (JAX) (B, P + gen) ids equal, or first
    differ at a near-tie of JAX's logits (see the module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :p_len], want[:, :p_len])
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        row = jnp.asarray(want[b:b + 1, :t])
        logits, _ = jm.prefill(jp, row, jm.init_cache(1, t))
        lg = np.sort(np.asarray(logits[0, 0, :vocab], np.float64))
        margin = lg[-1] - lg[-2]
        assert margin <= NEAR_TIE * np.abs(lg).max(), \
            f"row {b} differs at {t} with a top-2 margin of {margin}"


def _naive_generate(model, params, prompts, gen):
    """The token-by-token reference: the prompt one decode step a token."""
    b, p_len = prompts.shape
    caches = model.init_cache(b, p_len + gen, device=prompts.device)
    logits = None
    for t in range(p_len):
        logits, caches = model.decode_step(params, prompts[:, t:t + 1], t,
                                           caches)
    out = [prompts]
    for t in range(p_len, p_len + gen):
        cur = logits[:, 0, :model.cfg.vocab_size].argmax(-1)[:, None]
        out.append(cur)
        logits, caches = model.decode_step(params, cur, t, caches)
    return torch.cat(out, dim=1)


def _prompts(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None),
                                         ("qwen3-0.6b", 8),
                                         ("nano-lm", None)])
def test_generate_matches_jax(arch, window):
    jc, tc = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    if window:
        jc, tc = jc.windowed(window), tc.windowed(window)
    jm, tm = JModel(jc), Model(tc)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    prompts = _prompts(jc, (2, 7), seed=1)
    want = j_generate(jm, jp, jnp.asarray(prompts), gen=12)
    got = generate(tm, tp, torch.from_numpy(prompts).long(), gen=12)
    assert_ids_match_jax(got.numpy(), np.asarray(want), jm, jp,
                         jc.vocab_size, 7)


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_prefill_ids_match_token_loop(window):
    cfg = get_config("qwen3-0.6b", reduced=True)
    if window:
        cfg = cfg.windowed(window)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_prompts(cfg, (2, 7), seed=1)).long()
    got = generate(model, params, prompts, gen=6)
    assert got.shape == (2, 13) and got.dtype == prompts.dtype
    assert torch.equal(got, _naive_generate(model, params, prompts, 6))


def test_decode_step_per_slot_positions():
    """Row 0 at position 5 and row 1 at position 2 in ONE batch equal two
    references at the same batch shape (both rows duplicated, scalar
    positions), bit for bit; row 1 re-feeds its last token at its frozen
    position, as a staggered slot batch does."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, 6))
    u = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3))

    def duo(stream):
        caches = model.init_cache(2, 16, device="cpu")
        for i, tok in enumerate(stream):
            logits, caches = model.decode_step(
                params, torch.full((2, 1), int(tok)), i, caches)
        return logits

    ref_a, ref_b = duo(t), duo(u)
    caches = model.init_cache(2, 16, device="cpu")
    for i in range(6):
        j = min(i, 2)
        toks = torch.stack([t[i], u[j]])[:, None]
        pos = torch.tensor([i, j], dtype=torch.int32)
        logits, caches = model.decode_step(params, toks, pos, caches)
    assert torch.equal(logits[0], ref_a[0])
    assert torch.equal(logits[1], ref_b[1])


def test_make_serve_step_is_decode_step():
    cfg = get_config("nano-lm", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 8, device="cpu")
    toks = torch.tensor([[3], [5]])
    logits, new = make_serve_step(model)(params, caches, toks, 0)
    want, want_c = model.decode_step(params, toks, 0, caches)
    assert not logits.requires_grad
    assert torch.equal(logits, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                 tree_leaves(want_c)))
    # the caches passed in are left as they were
    assert all((a == 0).all() for a in tree_leaves(caches)
               if a.dtype != torch.int32)


def test_cli_on_cpu(capsys):
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "5",
            "--gen", "4"]
    ids = serve.main(argv)
    cfg = get_config("qwen3-0.6b", reduced=True)
    assert ids.shape == (2, 9) and ids.device.type == "cpu"
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size
    assert "[serve] qwen3-0.6b: generated 8 tokens" in capsys.readouterr().out
    assert torch.equal(serve.main(argv), ids)   # seeded: the same ids
    # the CLI's greedy ids are generate's on the same weights and prompts
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(generate(model, params, prompts, 4), ids)


def test_cli_temperature_draws_from_the_generator():
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "4",
            "--gen", "6", "--temperature", "0.8"]
    a, b = serve.main(argv), serve.main(argv)
    assert torch.equal(a, b)
    c = serve.main(argv[:-1] + ["1e-4"])   # a cold sample is the argmax
    assert torch.equal(c, serve.main(argv[:-2]))


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "1"])


@pytest.mark.gpu
def test_generate_on_card_equals_token_loop():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.from_numpy(_prompts(cfg, (2, 7), seed=1)).long().cuda()
    got = generate(model, params, prompts, gen=6)
    assert torch.equal(got, _naive_generate(model, params, prompts, 6))
    cpu = generate(model, tree_map(lambda a: a.cpu(), params),
                   prompts.cpu(), gen=6)
    assert got.shape == cpu.shape
