"""Position-keyed sampling of the port against ``repro.engine.sampling``:
threefry keys bit-equal, Gumbel noise within 1e-6, sampled tokens and
draft acceptance equal, log-probabilities within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import sampling as js
from repro_torch.engine import sampling as ts

torch.set_num_threads(2)


def _keys(base_seed, seeds, positions):
    want = np.asarray(js.position_keys(jax.random.PRNGKey(base_seed),
                                       jnp.asarray(seeds),
                                       jnp.asarray(positions)))
    got = ts.position_keys(ts.prng_key(base_seed), torch.from_numpy(seeds),
                           torch.from_numpy(positions)).numpy()
    return want, got


@pytest.mark.parametrize("base_seed", [0, 7, 123_456_789, 2**31 - 1])
def test_position_keys_bit_equal(base_seed):
    rng = np.random.default_rng(base_seed % 1000)
    seeds = rng.integers(-2**31, 2**31 - 1, size=(6,)).astype(np.int32)
    seeds[0] = 0
    positions = rng.integers(0, 70_000, size=(6, 9)).astype(np.int32)
    want, got = _keys(base_seed, seeds, positions)
    assert want.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_gumbel_noise_matches():
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 10**6, size=(3,)).astype(np.int32)
    positions = rng.integers(0, 4096, size=(3, 2)).astype(np.int32)
    want_keys, got_keys = _keys(5, seeds, positions)
    V = 1000
    got = ts.gumbel(torch.from_numpy(got_keys), V).numpy()
    for b in range(3):
        for t in range(2):
            key = jax.random.wrap_key_data(jnp.asarray(want_keys[b, t]))
            want = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
            np.testing.assert_allclose(got[b, t], want, atol=1e-6,
                                       rtol=1e-6)


def _sample_inputs(seed, B=4, T=3, V=700):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, V)) * 3).astype(np.float32)
    seeds = rng.integers(0, 10**6, size=(B,)).astype(np.int32)
    positions = rng.integers(0, 4096, size=(B, T)).astype(np.int32)
    return logits, seeds, positions


@pytest.mark.parametrize("temp", [0.0, 1.0, 0.7])
def test_sample_tokens_equal(temp):
    logits, seeds, positions = _sample_inputs(int(temp * 10))
    B = logits.shape[0]
    temps = np.full((B,), temp, np.float32)
    temps[1] = 0.0
    rows = np.array([1, 1, 0, 1], bool)
    jkeys = js.position_keys(jax.random.PRNGKey(3), jnp.asarray(seeds),
                             jnp.asarray(positions))
    tkeys = ts.position_keys(ts.prng_key(3), torch.from_numpy(seeds),
                             torch.from_numpy(positions))
    for row_valid in (None, rows):
        want = np.asarray(js.sample_tokens(
            jnp.asarray(logits), jkeys, jnp.asarray(temps),
            None if row_valid is None else jnp.asarray(row_valid)))
        got = ts.sample_tokens(
            torch.from_numpy(logits), tkeys, torch.from_numpy(temps),
            None if row_valid is None else torch.from_numpy(row_valid))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_draft_acceptance_equal():
    rng = np.random.default_rng(4)
    B, T = 16, 9
    sampled = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    tokens = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    anchor = rng.integers(0, 3, size=(B,)).astype(np.int32)
    n_drafts = rng.integers(0, T - 3, size=(B,)).astype(np.int32)
    # make some chains accept: copy the sampled chain into the drafts
    for b in range(0, B, 2):
        a = anchor[b]
        tokens[b, a + 1:] = sampled[b, a:T - 1]
    want = np.asarray(js.draft_acceptance(*map(jnp.asarray, (
        sampled, tokens, anchor, n_drafts))))
    got = ts.draft_acceptance(*map(torch.from_numpy, (
        sampled, tokens, anchor, n_drafts)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0
    one = ts.draft_acceptance(*map(torch.from_numpy, (
        sampled[:, :1], tokens[:, :1], anchor * 0, n_drafts * 0)))
    assert not one.any()


def test_token_logprobs_at_matches():
    logits, _, _ = _sample_inputs(9)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, logits.shape[-1], size=logits.shape[:2])
    toks = toks.astype(np.int32)
    toks[0, 0] = -1                 # a prefill row's -1 indexes from the end
    want = np.asarray(js.token_logprobs_at(jnp.asarray(logits),
                                           jnp.asarray(toks)))
    got = ts.token_logprobs_at(torch.from_numpy(logits),
                               torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
