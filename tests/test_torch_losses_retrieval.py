"""The port's loss, temperature schedule and retrieval against the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.eval.retrieval import l2_topk as jax_l2_topk
from cerebra.eval.retrieval import retrieval_recall_precision as jax_rp
from cerebra.losses import feature_distribution_loss_v1 as jax_v1
from cerebra.losses import teacher_temp_schedule as jax_schedule
from cerebra_torch.eval.retrieval import l2_topk, retrieval_recall_precision
from cerebra_torch.losses import feature_distribution_loss_v1, teacher_temp_schedule

torch.set_num_threads(1)


@pytest.mark.parametrize("temperature", [0.1, 0.5, 1.5])
def test_feature_distribution_loss_v1_matches_jax(temperature):
    rng = np.random.default_rng(0)
    s, t = rng.normal(size=(2, 6, 10)).astype(np.float32)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    labels = rng.integers(0, 4, size=6)
    want = jax_v1(jnp.asarray(s), jnp.asarray(t), jnp.asarray(labels), jnp.asarray(logits),
                  temperature=temperature, alpha=0.3, beta=0.7)
    got = feature_distribution_loss_v1(
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(labels),
        torch.from_numpy(logits), temperature=temperature, alpha=0.3, beta=0.7,
    )
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("args", [(1.5, 0.22, 50, 100), (0.04, 0.07, 3, 10), (-0.004, 0.04, 5, 3)])
def test_teacher_temp_schedule_equals_jax(args):
    np.testing.assert_array_equal(teacher_temp_schedule(*args), jax_schedule(*args))


def test_l2_topk_ties_go_to_the_lower_index():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(4, 8)).astype(np.float32)
    gallery = np.concatenate([base, base, base[:2]])  # every row has exact twins
    query = np.concatenate([base[[2, 0]], rng.normal(size=(3, 8)).astype(np.float32)])
    want_d, want_i = jax_l2_topk(jnp.asarray(gallery), jnp.asarray(query), 5)
    got_d, got_i = l2_topk(torch.from_numpy(gallery), torch.from_numpy(query), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)
    assert got_i[0, 0] == 2 and got_i[0, 1] == 6  # twin at 2 before 6


def test_retrieval_recall_precision_on_overlapping_classes():
    """Classes whose means sit close together under wide noise, so R and P
    are well below 100 and the scores test something."""
    rng = np.random.default_rng(2)
    n_classes, dim = 6, 12
    means = rng.normal(size=(n_classes, dim)) * 0.3
    g_lab = rng.integers(0, n_classes, size=120)
    q_lab = rng.integers(0, n_classes, size=40)
    gallery = (means[g_lab] + rng.normal(size=(120, dim))).astype(np.float32)
    query = (means[q_lab] + rng.normal(size=(40, dim))).astype(np.float32)
    want = jax_rp(jnp.asarray(gallery), jnp.asarray(query), jnp.asarray(g_lab),
                  jnp.asarray(q_lab), k=5)
    got = retrieval_recall_precision(torch.from_numpy(gallery), torch.from_numpy(query),
                                     g_lab, q_lab, k=5)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[0] < 90 and got[1] < 60
