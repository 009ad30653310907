"""The serving twin (``repro_torch.examples.serve_lm``) against the JAX
example's fleet, written here with the JAX package as
``examples/serve_lm.py`` writes it (reduced nano-lm, 8 replicas on a
lossy ring, the last killed at round 20, ``ServeLoad(rate=1,
prompt_len=(3, 6), gen_len=(4, 10))``, ``max_batch=4``, ``max_len=24``,
drift scale 0.02), on the CPU with JAX's weights carried over and the
noise-free drift of ``test_torch_fleet.py`` given to both packages in
place of the Gaussian one.  24 rounds, so that the kill falls inside the
run.

Tolerances: request counts, restarts, losses, latencies and the
completed uids exactly; the final bank within rtol 1e-6 plus 1e-6 of its
largest magnitude and the consensus trace at rtol 1e-5 (f32 mixing and
drift steps summed in another order by XLA and PyTorch).  Then ``main``
on ``--device cpu`` prints the example's two lines with every field
finite, and without a card and without ``--device cpu`` it raises.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.configs.nano_lm import reduced as j_reduced
from repro.launch.fleet import GossipFleet as JGossipFleet
from repro.models import Model as JModel
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.examples import serve_lm

ROUNDS = 24
BANK_RTOL = 1e-6


def _j_drift(p, key, wid):
    """Noise-free drift, per replica (the JAX Simulator signature)."""
    g = jax.tree.map(lambda a: 0.1 * a + 0.01 * (wid + 1), p)
    return sum(jnp.sum(a ** 2) for a in jax.tree.leaves(p)), g


def _t_drift(x, generator, ids):
    """The same drift, batched over replicas (the port's signature)."""
    def g(a):
        c = (0.01 * (ids + 1)).reshape((-1,) + (1,) * (a.dim() - 1))
        return 0.1 * a + c.to(a.dtype)
    losses = sum((a ** 2).reshape(a.shape[0], -1).sum(1)
                 for a in tree_leaves(x))
    return losses, tree_map(g, x)


def j_world():
    return J.World(
        topology=J.ring_graph(8),
        algorithm=J.Algorithm("a2cid2"),
        channel=J.ChannelModel(delay=J.DelayProcess(horizon=2, prob=0.3),
                               drop_prob=0.1),
        faults=(J.PhaseSwitch(20, active=(True,) * 7 + (False,)),),
        serve=J.ServeLoad(rate=1.0, prompt_len=(3, 6), gen_len=(4, 10)),
    )


def test_world_is_the_examples():
    assert serve_lm.make_world().to_dict() == j_world().to_dict()


def test_fleet_matches_jax_with_noise_free_drift():
    jm = JModel(j_reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    jrep = JGossipFleet(jm, jp, j_world(), max_batch=4, max_len=24,
                        drift_scale=0.02, grad_fn=_j_drift).run(
        rounds=ROUNDS, seed=0)
    trep = serve_lm.run("cpu", ROUNDS, 0,
                        params=params_from_jax(jax.device_get(jp), "cpu"),
                        grad_fn=_t_drift)
    assert jrep.restarted >= 1 and jrep.lost == 0   # the kill happened
    for f in ("requests_total", "lost", "restarted", "drain_rounds",
              "rounds", "tokens_generated"):
        assert getattr(trep, f) == getattr(jrep, f), f
    for f in ("latencies", "ttft"):
        np.testing.assert_array_equal(getattr(trep, f), getattr(jrep, f))
    assert [q.uid for q in trep.completed] == [q.uid for q in jrep.completed]
    for a, b in zip(trep.completed, jrep.completed):
        assert (a.arrive_round, a.admit_round, a.done_round, a.restarts,
                len(a.out)) == (b.arrive_round, b.admit_round, b.done_round,
                                b.restarts, len(b.out))
    want = np.asarray(jrep.final_bank)
    np.testing.assert_allclose(trep.final_bank.numpy(), want,
                               rtol=BANK_RTOL,
                               atol=BANK_RTOL * np.abs(want).max())
    np.testing.assert_allclose(trep.consensus, jrep.consensus, rtol=1e-5,
                               atol=1e-7)
    assert serve_lm.report_lines(trep)[1] == (
        f"churn recovery: replica killed at round 20 — lost {jrep.lost}, "
        f"re-admitted {jrep.restarted} in-flight requests to survivors")


def test_main_on_cpu_prints_finite_fields(capsys):
    rep = serve_lm.main(["--device", "cpu", "--rounds", str(ROUNDS)])
    printed = capsys.readouterr().out.splitlines()
    assert printed == serve_lm.report_lines(rep)
    head = re.match(r"^fleet: (\d+)/(\d+) requests, (\S+) tok/s, p95 "
                    r"latency (\S+) rounds, consensus distance (\S+)$",
                    printed[0])
    assert head, printed[0]
    assert all(math.isfinite(float(v)) for v in head.groups())
    assert re.match(r"^churn recovery: replica killed at round 20 — lost "
                    r"\d+, re-admitted \d+ in-flight requests to survivors$",
                    printed[1])
    assert rep.lost == 0 and rep.restarted >= 1
    assert rep.final_bank.device.type == "cpu"


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--rounds", "1"])
