"""The PyTorch port's mask functions (`ops/masks.py`) against the JAX
package's, on the CPU, from numpy seeds.

  * `rescale_prob` rescaling up, down, and with every probability
    saturated (sigmoid(20) == 1 in f32): values at rtol 1e-6, and a
    finite gradient through `loupe_sample` in both packages.
  * `loupe_init_weight` bit for bit, `loupe_pmask` at rtol 1e-6.
  * `loupe_sample` from JAX's own thresholds (`jax.random.uniform` of the
    key): the soft mask at rtol 1e-5, atol 1e-7, the hard mask and
    `pruned` equal; from a `torch.Generator` without thresholds, and the
    refusal to draw from neither; the refusal of a sparsity that keeps no
    line.
  * `magnitude_prune` equal on every case of one parametrised test.
  * `make_mask("loupe")`: the logits bit for bit, the kept line count.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.ops import masks as jmasks

from spatialalignmentnetwork_tpu_torch.ops import masks as tmasks

W = 32
SPARSITY = 0.25
PMASK_SLOPE, SAMPLE_SLOPE = 5.0, 12.0


def _weight(seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(W) * scale).astype(np.float32)


@pytest.mark.parametrize("case", ["up", "down", "saturated"])
def test_rescale_prob_matches_jax_with_finite_gradients(case):
    """Mean above the sparsity (scale down), below it (scale up), and every
    probability at 1.0 in f32, where the branch not taken divides by 0:
    both packages give the same values and a finite logits gradient."""
    x = {"up": np.random.default_rng(1).uniform(0.3, 0.9, W),
         "down": np.random.default_rng(2).uniform(0.0, 0.3, W),
         "saturated": np.ones(W)}[case].astype(np.float32)
    got = tmasks.rescale_prob(torch.from_numpy(x), SPARSITY)
    want = jmasks.rescale_prob(jnp.asarray(x), SPARSITY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(float(got.mean()), SPARSITY, rtol=1e-5)

    logits = np.full(W, 4.0, np.float32) if case == "saturated" else _weight(3)
    key = jax.random.PRNGKey(0)
    thresh = np.array(jax.random.uniform(key, (2, W)))

    def jloss(w):
        return jnp.sum(jmasks.loupe_sample(w, SPARSITY, PMASK_SLOPE, SAMPLE_SLOPE, key,
                                           batch=2, training=True)[0])

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    w = torch.tensor(logits, requires_grad=True)
    mask, _ = tmasks.loupe_sample(w, SPARSITY, PMASK_SLOPE, SAMPLE_SLOPE, batch=2,
                                  training=True, thresh=torch.from_numpy(thresh))
    mask.sum().backward()
    assert np.isfinite(w.grad.numpy()).all() and np.isfinite(jgrad).all()
    np.testing.assert_allclose(w.grad.numpy(), jgrad, rtol=1e-4,
                               atol=1e-6 * float(np.abs(jgrad).max()) + 1e-30)


def test_loupe_init_weight_and_pmask_match_jax():
    got = tmasks.loupe_init_weight(W, PMASK_SLOPE, np.random.default_rng(7))
    want = jmasks.loupe_init_weight(W, PMASK_SLOPE, np.random.default_rng(7))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tmasks.loupe_pmask(torch.from_numpy(got), SPARSITY, PMASK_SLOPE).numpy(),
        np.asarray(jmasks.loupe_pmask(jnp.asarray(want), SPARSITY, PMASK_SLOPE)), rtol=1e-6)


@pytest.mark.parametrize("training", [True, False])
def test_loupe_sample_from_jax_thresholds(training):
    """The port fed the thresholds JAX draws from its key: the same mask
    and the same `pruned` (the k-th largest score kept, ties included)."""
    weight = tmasks.loupe_init_weight(W, PMASK_SLOPE, np.random.default_rng(4))
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        thresh = np.array(jax.random.uniform(key, (3, W)))
        jmask, jpruned = jmasks.loupe_sample(jnp.asarray(weight), SPARSITY, PMASK_SLOPE,
                                             SAMPLE_SLOPE, key, batch=3, training=training)
        mask, pruned = tmasks.loupe_sample(torch.from_numpy(weight), SPARSITY, PMASK_SLOPE,
                                           SAMPLE_SLOPE, batch=3, training=training,
                                           thresh=torch.from_numpy(thresh))
        np.testing.assert_array_equal(pruned.numpy(), np.asarray(jpruned))
        assert int((~pruned).sum()) == int(SPARSITY * W + 0.5)
        if training:
            np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_loupe_sample_draws_from_its_generator_only():
    """Without thresholds the draws come from the generator given (the same
    seed, the same mask); with neither it raises, whatever the global RNG."""
    w = torch.from_numpy(_weight(5))
    a = tmasks.loupe_sample(w, SPARSITY, PMASK_SLOPE, SAMPLE_SLOPE, 2, True,
                            generator=torch.Generator().manual_seed(3))
    torch.manual_seed(123)
    b = tmasks.loupe_sample(w, SPARSITY, PMASK_SLOPE, SAMPLE_SLOPE, 2, True,
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="thresh"):
        tmasks.loupe_sample(w, SPARSITY, PMASK_SLOPE, SAMPLE_SLOPE, 2, True)


def test_a_loupe_mask_that_keeps_no_line_is_refused():
    """int(sparsity W + 0.5) = 0: the k-th largest would keep every line."""
    for sample in (lambda: tmasks.loupe_sample(torch.zeros(16), 0.01, PMASK_SLOPE,
                                               SAMPLE_SLOPE, 1, False,
                                               generator=torch.Generator()),
                   lambda: jmasks.loupe_sample(jnp.zeros(16), 0.01, PMASK_SLOPE,
                                               SAMPLE_SLOPE, jax.random.PRNGKey(0), 1,
                                               False)):
        with pytest.raises(ValueError, match="keeps 0 lines"):
            sample()


MAGNITUDE_CASES = {
    "two smallest": (np.array([0.5, 0.1, 0.9, 0.05, 2.0]), [], 2, 1.0, 0.0),
    "none below thres": (np.array([1.5, 1.0, 2.0, 3.0]), [], 2, 1.0, 0.0),
    "skips pruned": (np.array([0.5, 0.1, 0.9, 0.05, 2.0]), [3], 2, 1.0, 0.0),
    "more than can go": (np.array([0.5, 0.1, 0.9, 0.05, 2.0]), [], 9, 1.0, 0.0),
    "num 0": (np.array([0.5, 0.1]), [], 0, 1.0, 0.0),
    "negative weights": (np.array([-0.2, 0.3, -0.01, 0.7, -1.5]), [], 3, 0.5, 0.0),
    "jittered": (np.random.default_rng(8).uniform(0, 1, W), [1, 4], 6, 1.0, 0.3),
    "ties": (np.array([0.2, 0.2, 0.2, 0.1, 0.2, 0.2]), [], 3, 1.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(MAGNITUDE_CASES))
def test_magnitude_prune_matches_jax(case):
    w, pruned_idx, num, thres, random = MAGNITUDE_CASES[case]
    pruned = np.zeros(w.shape[0], bool)
    pruned[pruned_idx] = True
    got = tmasks.magnitude_prune(w.astype(np.float32), pruned, num, thres, random,
                                 rng=np.random.default_rng(11))
    want = jmasks.magnitude_prune(w.astype(np.float32), pruned, num, thres, random,
                                  rng=np.random.default_rng(11))
    np.testing.assert_array_equal(got, want)
    assert not np.any(pruned & ~got)  # pruned lines stay pruned
    assert got.sum() - pruned.sum() <= num


@pytest.mark.parametrize("seed", [0, 3])
def test_make_mask_loupe_weight_matches_jax(seed):
    """A fresh LOUPE build: JAX's logits bit for bit and its slopes; the
    first `pruned` (a torch draw, not JAX's threefry one) keeps
    int(sparsity W + 0.5) lines, the same for the same seed."""
    got = tmasks.make_mask("loupe", W, SPARSITY, seed=seed)
    want = jmasks.make_mask("loupe", W, SPARSITY, seed=seed)
    np.testing.assert_array_equal(got.weight, want.weight)
    assert (got.pmask_slope, got.sample_slope) == (want.pmask_slope, want.sample_slope)
    assert int((~got.pruned).sum()) == int((~want.pruned).sum()) == int(SPARSITY * W + 0.5)
    np.testing.assert_array_equal(got.pruned, tmasks.make_mask("loupe", W, SPARSITY,
                                                               seed=seed).pruned)
    net = tmasks.MaskNet(got.weight)
    assert [n for n, _ in net.named_parameters()] == ["weight"]
    assert tmasks.MaskNet().weight is None and not list(tmasks.MaskNet().parameters())
