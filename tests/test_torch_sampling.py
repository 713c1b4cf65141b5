"""The port's sampler (``serving/sampler.py``) and sampled dense decoding
(CPU, fp32, the llama2-7b smoke config).

``jax.random`` cannot be matched, so the samples are held to the
sampler's contract instead: a row's key is a pure function of (session
seed, the row's position before the step, the token fed), so a row's
samples do not depend on its batch or slot, do not change under
``step(num_ticks=4)``, and replay exactly; two seeds diverge. The
temperature / top-k scaling and the greedy path are held to JAX's
exactly, and the draws to softmax(logits / T) under top-k by a
chi-square test of 20000 seeded (so deterministic) draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import DenseStrategy, Engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402

SAMPLED = DenseStrategy(temperature=0.8, top_k=50)


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("llama2-7b").smoke()
    m_j = jbuild(run_j)
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                  sw_np.offline_mask, "cpu", torch.float32)
    run = get_config("llama2-7b").smoke()
    return run, build_model(run), params, sw


def _logits(seed, B=6, V=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    x[0, 5] = x[0, 9] = x[0].max() + 1.0            # a tie in row 0
    x[1, :] = 0.5                                     # a flat row
    return x


@pytest.mark.parametrize("temperature,top_k", [(1.0, None), (0.7, 5),
                                               (2.5, 1), (0.3, 64)])
def test_scale_matches_jax(temperature, top_k):
    """logits / T, then every logit below the k-th largest masked to
    -1e30 (ties at the k-th value all kept), as JAX's ``_scale``."""
    x = _logits(0)
    want = jsampler._scale(jnp.asarray(x), temperature, top_k)
    got = sampler._scale(torch.from_numpy(x), temperature, top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_greedy_matches_jax_with_ties_to_lowest_id(temperature):
    x = _logits(1)
    want = np.asarray(jsampler.sample(jnp.asarray(x), jax.random.PRNGKey(0),
                                      temperature=temperature))
    keys = sampler.row_keys(3, torch.arange(6), torch.arange(6))
    for got in (sampler.sample(torch.from_numpy(x), 3, temperature),
                sampler.sample_rows(torch.from_numpy(x), keys, temperature)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[0]) == 5 and int(want[1]) == 0


def test_row_keys_are_pure_functions_of_row_history():
    """A row's key and sample depend on (seed, pos, token) alone: not on
    the row's place in the batch, the batch's other rows or its size; a
    different seed, position or token gives another key."""
    x = torch.from_numpy(_logits(2, B=5, V=300))
    pos = torch.tensor([0, 7, 7, 130, 2 ** 20], dtype=torch.int32)
    tok = torch.tensor([3, 3, 4, 0, 511], dtype=torch.int32)
    keys = sampler.row_keys(11, pos, tok)
    assert keys.dtype == torch.int64 and len(set(keys.tolist())) == 5
    out = sampler.sample_rows(x, keys, 0.9, 40)
    perm = torch.tensor([3, 0, 4, 2, 1])
    out_p = sampler.sample_rows(x[perm], sampler.row_keys(11, pos[perm],
                                                          tok[perm]), 0.9, 40)
    assert out_p.tolist() == out[perm].tolist()
    for r in range(5):
        one = sampler.sample_rows(x[r:r + 1], sampler.row_keys(
            11, pos[r:r + 1], tok[r:r + 1]), 0.9, 40)
        assert int(one) == int(out[r])
    assert not torch.equal(sampler.row_keys(12, pos, tok), keys)


def test_draws_follow_softmax_under_top_k():
    """Chi-square of 20000 draws (one row each, keys from 20000 positions)
    against softmax(logits / T) over the top-k: p > 1e-3; nothing outside
    the top k is ever drawn. Seeded, so the verdict never changes."""
    from scipy.stats import chisquare
    rng = np.random.default_rng(4)
    V, N, T, k = 16, 20000, 0.7, 10
    logits = rng.standard_normal(V).astype(np.float32) * 1.5
    x = torch.from_numpy(np.repeat(logits[None], N, axis=0))
    keys = sampler.row_keys(5, torch.arange(N), torch.full((N,), 3))
    draws = sampler.sample_rows(x, keys, T, k).numpy()
    top = np.argsort(-logits, kind="stable")[:k]
    assert set(draws.tolist()) <= set(top.tolist())
    p = np.exp((logits[top].astype(np.float64) - logits[top].max()) / T)
    p /= p.sum()
    obs = np.bincount(draws, minlength=V)[top]
    exp = p * (obs.sum() / p.sum())
    assert chisquare(obs, exp).pvalue > 1e-3


def _sampled_session(m, params, sw, prompts, seed, new, cache="dense",
                     ticks=None):
    s = Engine.create(m, params, sw, strategy=SAMPLED).new_session(
        prng_seed=seed, cache=cache)
    first = s.prefill(prompts, max_new_tokens=new)
    rows = [first.row_tokens(b) for b in range(first.batch)]
    while not s.all_done():
        res = s.step(num_ticks=ticks)
        for b in range(res.batch):
            rows[b].extend(res.row_tokens(b))
    return rows


def test_sampled_sessions_batch_and_megatick_invariant(setup):
    """A row samples the same tokens alone or in a batch (either slot), on
    the dense and the paged cache, and as megaticks of 4; the first token
    is the prefill's greedy argmax whatever the seed."""
    run, m, params, sw = setup
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 512, (2, 9))
    both = _sampled_session(m, params, sw, np.stack([a, b]), 7, 10)
    swapped = _sampled_session(m, params, sw, np.stack([b, a]), 7, 10,
                               cache="paged")
    alone = _sampled_session(m, params, sw, a[None], 7, 10)
    mega = _sampled_session(m, params, sw, np.stack([a, b]), 7, 10,
                            ticks=4)
    assert both == swapped[::-1] == mega
    assert alone[0] == both[0]
    greedy = Engine.create(m, params, sw, strategy="dense").new_session()
    g = greedy.prefill(a[None], max_new_tokens=1).row_tokens(0)
    other = _sampled_session(m, params, sw, a[None], 8, 10)
    assert other[0][0] == alone[0][0] == g[0]
    assert other[0] != alone[0]


def test_serving_prng_seed_threads_through(setup):
    """``tests/test_api.py``'s case on the port: under sampling two seeds
    diverge and one seed reproduces, whatever the slot the request lands
    in."""
    run, m, params, sw = setup
    prompt = np.random.default_rng(3).integers(0, 512, 7).astype(np.int32)

    def sample_run(seed, lead=0):
        se = ServingEngine(m, params, sw,
                           strategy=DenseStrategy(temperature=1.0),
                           prng_seed=seed)
        for _ in range(lead):         # another request takes slot 0
            se.submit(prompt[::-1].copy(), max_new_tokens=12)
        r = se.submit(prompt, max_new_tokens=12)
        se.run_to_completion()
        return r.output

    a0, a1, a0_again = sample_run(0), sample_run(1), sample_run(0)
    assert a0 != a1, "different seeds produced identical samples"
    assert a0 == a0_again == sample_run(0, lead=1), \
        "same seed not reproducible"


def test_serving_greedy_ignores_seed(setup):
    run, m, params, sw = setup
    prompt = np.random.default_rng(5).integers(0, 512, 6).astype(np.int32)
    outs = []
    for seed in (0, 1):
        se = ServingEngine(m, params, sw, strategy="dense", prng_seed=seed)
        r = se.submit(prompt, max_new_tokens=6)
        se.run_to_completion()
        outs.append(r.output)
    assert outs[0] == outs[1]
