"""Port parity of serving (``repro_torch.serving``) against ``repro``'s jnp
path at yi-6b's reduced config, float32, on the reference's parameters
carried across bit for bit (``from_reference_params``):

  * greedy token streams of a mixed-length request stream through the
    continuous-batching loop equal the reference's, dense and GUST
    (padded, ragged, compact bf16/int16), with the same statuses and
    loop counters;
  * ``gustify``'s stacked leaves, meta and stats are bitwise the
    reference's;
  * GUST at density 1.0 is the dense decode within ``1e-4`` of the
    largest logit (the products sum in another order);
  * solo ≡ concurrent bitwise inside the port, dense and GUST, also for a
    request admitted mid-decode.

Lifecycle statuses, faults, sampling, specs, the CLI and the entry
points' devices are in ``test_torch_serving_lifecycle.py``.
"""

import numpy as np
import pytest
import torch

import jax
import repro.resilience as RR
import repro.serving as RS
from repro.serving.gust_serve import gustify as ref_gustify

from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build

import repro_torch.resilience as TR
import repro_torch.serving as TS
from repro_torch.configs import get_arch
from repro_torch.core.convert import from_reference_params, to_numpy_leaves
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.gust_serve import decode_step_gust, gustify

torch.set_num_threads(1)

GUST = {
    "dense": None,
    "padded": dict(density=0.5, gust_length=16),
    "ragged": dict(density=0.3, gust_length=16, ragged=True),
    "compact": dict(density=0.3, gust_length=16, compact=True),
}


@pytest.fixture(scope="module")
def model():
    """(reference LM, its params, the port's LM, the same params)."""
    rlm = ref_build(ref_get_arch("yi_6b").reduced())
    rp = jax.jit(rlm.init)(jax.random.PRNGKey(0))
    cfg = get_arch("yi_6b").reduced()
    return rlm, rp, build_model(cfg), from_reference_params(
        jax.tree.map(np.asarray, rp), cfg, device="cpu")


def prompts(vocab, lengths=(5, 11, 7, 9, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def configs(batch=2, gust=None, **kw):
    """The same ServeConfig for both packages."""
    return (RS.ServeConfig(batch=batch, seq_len=64, dtype="float32",
                           gust=None if gust is None else RS.GustServeConfig(**gust), **kw),
            TS.ServeConfig(batch=batch, seq_len=64, dtype="float32",
                           gust=None if gust is None else TS.GustServeConfig(**gust), **kw))


def solo(lm, params, prompt, max_new, *, batch=2, gust=None, **kw):
    """Serve one request alone on an otherwise idle port engine."""
    loop = TS.ServeLoop(lm, params, configs(batch, gust, **kw)[1])
    rid = loop.submit(prompt, max_new=max_new)
    loop.run_to_completion()
    return loop.results[rid].tokens


@pytest.mark.parametrize("mode", list(GUST))
def test_greedy_streams_equal_reference(model, mode):
    # resilience_stats() adds each package's process-wide fallback
    # counters, which other test files in the same worker may have moved
    RR.reset_fallback_counters()
    TR.reset_fallback_counters()
    rlm, rp, lm, p = model
    rsc, tsc = configs(gust=GUST[mode])
    ref, port = RS.ServeLoop(rlm, rp, rsc), TS.ServeLoop(lm, p, tsc)
    for loop in (ref, port):
        for prompt in prompts(lm.cfg.vocab):
            loop.enqueue(prompt, max_new=6)
        loop.run_to_completion()
    assert port.completed == ref.completed and len(port.completed) == 5
    assert port.stats == ref.stats
    assert port.occupancy == ref.occupancy
    assert port.resilience_stats() == ref.resilience_stats()


@pytest.mark.parametrize("mode", ["padded", "ragged", "compact"])
def test_gustify_is_bitwise_the_reference(model, mode):
    rlm, rp, lm, p = model
    gcfg = GUST[mode]
    want = ref_gustify(rlm, rp, RS.GustServeConfig(**gcfg))
    got = gustify(lm, p, TS.GustServeConfig(**gcfg))
    assert set(got["mats"]) == set(want["mats"]) == {"w_gate", "w_up", "w_down"}
    for name, entry in want["mats"].items():
        assert tuple(got["mats"][name]["meta"]) == tuple(entry["meta"])
        leaves = to_numpy_leaves(got["mats"][name]["leaves"])
        assert set(leaves) == set(entry["leaves"])
        for k, v in entry["leaves"].items():
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                v = v.view(np.int16)
            assert leaves[k].dtype == v.dtype and np.array_equal(leaves[k], v), (name, k)
    assert got["stats"] == want["stats"]
    assert set(got["seconds"]) == {"prune", "schedule", "pack"}


def test_gust_at_full_density_is_the_dense_decode(model):
    _, _, lm, p = model
    gcfg = TS.GustServeConfig(density=1.0, gust_length=16)
    gust = gustify(lm, p, gcfg)
    caches = lm.init_caches(2, 64, torch.float32, device="cpu")
    toks = torch.arange(8, dtype=torch.int32)[None].repeat(2, 1)
    _, caches = lm.prefill(p, {"tokens": toks}, caches, dtype=torch.float32)
    tok = torch.full((2, 1), 3, dtype=torch.int32)
    c_dense = {"reps": tuple({k: v.clone() for k, v in c.items()} for c in caches["reps"]),
               "tail": []}
    ld, _ = lm.decode_step(p, c_dense, tok, 8, dtype=torch.float32)
    lg, _ = decode_step_gust(lm, p, gust, caches, tok, 8, dtype=torch.float32)
    assert (ld - lg).abs().max() <= 1e-4 * ld.abs().max()
    for st in gust["stats"].values():
        assert st["stream_utilization"] > 0.5


@pytest.mark.parametrize("mode", ["dense", "padded"])
def test_solo_equals_concurrent_bitwise(model, mode):
    """Mixed prompt lengths decode at their own positions; a request
    admitted while another is mid-decode leaves it untouched."""
    _, _, lm, p = model
    gust = GUST[mode]
    ps = prompts(lm.cfg.vocab, (5, 11, 7))
    solos = [solo(lm, p, x, 6, batch=4, gust=gust) for x in ps]
    loop = TS.ServeLoop(lm, p, configs(4, gust)[1])
    rids = [loop.submit(ps[0], max_new=6)]
    for _ in range(3):  # the first request is now mid-decode
        loop.step()
    rids += [loop.submit(x, max_new=6) for x in ps[1:]]
    loop.run_to_completion()
    assert [loop.completed[r] for r in rids] == solos
