"""PyTorch port: the decode-time token samplers.

Greedy picks and the top-k / top-p masks are deterministic functions of
the logits and must equal the JAX package's exactly.  Draws cannot: the
port seeds a torch.Generator per (request seed, token index) where the
JAX engine folds the index into a threefry key.  So draws are checked
by their statistics, and by the property the engine relies on: a row's
draw depends on its own seed, index and logits only, never on its batch
neighbours or its position in the batch.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sampling_ops as jso
from paddle_tpu_torch.ops import sampling_ops as tso

V = 23


def _logits(seed, rows=6):
    return np.random.RandomState(seed).randn(rows, V).astype("f4") * 2.0


def test_greedy_matches_jax():
    import jax.numpy as jnp

    x = _logits(0)
    x[1, 3] = x[1, 7] = x[1].max() + 1.0     # a tie: first index wins
    np.testing.assert_array_equal(
        tso.greedy_sample(torch.from_numpy(x)).numpy(),
        np.asarray(jso.greedy_sample(jnp.asarray(x))))
    assert tso.greedy_sample(torch.from_numpy(x))[1] == 3


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 1, 3, 5, V, 40], [1.0] * 6),                 # top-k only
    ([0] * 6, [0.05, 0.3, 0.5, 0.8, 0.95, 1.0]),      # top-p only
    ([2, 4, 0, 7, 1, 10], [0.9, 0.4, 0.7, 1.0, 0.5, 0.6]),
])
def test_top_k_top_p_masks_match_jax(top_k, top_p):
    import jax.numpy as jnp

    x = _logits(1)
    k = np.asarray(top_k, "i4")
    p = np.asarray(top_p, "f4")
    want = np.asarray(jso.filter_top_k_top_p(jnp.asarray(x),
                                             jnp.asarray(k), jnp.asarray(p)))
    got = tso.filter_top_k_top_p(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[~np.isneginf(got)],
                                  want[~np.isneginf(want)])


def test_greedy_rows_need_no_generator():
    x = torch.from_numpy(_logits(2, rows=3))
    out = tso.sample_tokens([None] * 3, x, [0.0, -1.0, 0.0], [0] * 3,
                            [1.0] * 3)
    assert out.dtype == torch.int32
    assert out.tolist() == tso.greedy_sample(x).tolist()


def test_sampled_row_without_generator_raises():
    x = torch.from_numpy(_logits(3, rows=2))
    with pytest.raises(ValueError, match="no generator"):
        tso.sample_tokens([None, None], x, [0.0, 0.7], [0, 0], [1.0, 1.0])


def test_draws_follow_the_filtered_distribution():
    """4000 draws (one per token index, as the engine draws) against
    the softmax of the temperature-scaled logits: every category within
    5 standard deviations of its expected count (a false alarm has
    probability ~1e-5 per category)."""
    x = torch.from_numpy(_logits(4, rows=1))
    temp, n = 0.8, 4000
    counts = np.zeros(V)
    for i in range(n):
        g = tso.token_generator(11, i, torch.device("cpu"))
        counts[int(tso.sample_tokens([g], x, [temp], [0], [1.0])[0])] += 1
    prob = torch.softmax(x[0] / temp, dim=-1).numpy()
    sigma = np.sqrt(n * prob * (1 - prob))
    assert np.all(np.abs(counts - n * prob) <= 5 * sigma + 1)


def test_top_k_draws_stay_inside_the_top_k():
    x = torch.from_numpy(_logits(5, rows=1))
    top3 = set(torch.topk(x[0], 3).indices.tolist())
    seen = set()
    for i in range(300):
        g = tso.token_generator(3, i, torch.device("cpu"))
        seen.add(int(tso.sample_tokens([g], x, [1.5], [3], [1.0])[0]))
    assert seen <= top3 and len(seen) == 3


def test_draw_independent_of_batch_neighbours_and_position():
    """The row (seed 42, token 5) draws the same token alone, at another
    position, and beside neighbours with other logits and settings."""
    x = torch.from_numpy(_logits(6, rows=4))
    cpu = torch.device("cpu")

    def gen(seed, idx):
        return tso.token_generator(seed, idx, cpu)

    alone = tso.sample_tokens([gen(42, 5)], x[2:3], [1.0], [0], [0.9])
    mixed = tso.sample_tokens(
        [gen(1, 0), None, gen(42, 5), gen(7, 3)], x, [0.5, 0.0, 1.0, 2.0],
        [5, 0, 0, 2], [1.0, 1.0, 0.9, 0.5])
    moved = tso.sample_tokens(
        [gen(42, 5), gen(9, 9)], torch.stack([x[2], x[0]]), [1.0, 0.3],
        [0, 1], [0.9, 1.0])
    assert int(alone[0]) == int(mixed[2]) == int(moved[0])


def test_token_generator_keyed_by_seed_and_index():
    cpu = torch.device("cpu")

    def draw(seed, idx):
        return torch.rand(8, generator=tso.token_generator(seed, idx, cpu))

    assert torch.equal(draw(5, 17), draw(5, 17))
    assert not torch.equal(draw(5, 17), draw(5, 18))
    assert not torch.equal(draw(5, 17), draw(6, 17))
