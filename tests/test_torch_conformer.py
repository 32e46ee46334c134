"""The port's Conformer slice against the JAX package on the CPU: the
synthetic BCI-IV corpus and the `.mat` ingest bit for bit, the S&R gather
from JAX's own draws bit for bit, the patch embedding fused and unfused,
the Conformer forward in eval mode and in train mode with the same dropout
masks on both sides (and its running statistics after the step), its bf16
forward, five Adam steps from carried weights, and the CLI end to end with
its files.

Tolerances: data and the S&R gather exactly; f32 outputs 1e-5 of the
largest value (the same formulas, sums in another order; flax's LayerNorm
and BatchNorm take the variance in one pass, E[x²] − E[x]²), running
statistics 1e-5 relative; the bf16 forward 3e-2 of the largest value (a
bf16 rounding is 2^-8 relative, and 14 products and 5 LayerNorms in bf16
carry several); after five Adam steps the losses to 1e-5 relative and the
parameters by `_assert_params`: 99.5 % of each tensor's elements to 1e-6
and all to Adam's bound, 2·5·lr."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cerebra.models.conformer import Conformer as JaxConformer
from cerebra.models.conformer import PatchEmbedding as JaxPatchEmbedding
from cerebra.train import conformer_recipe as jrec
from cerebra_torch.cli import conformer_train as cli
from cerebra_torch.models import conformer as tconf
from cerebra_torch.train import conformer_recipe as trec
from tests._flax_dropout import DropoutMasks, replay

torch.set_num_threads(1)
TOL = 1e-5
C, T, B = 4, 200, 6  # 7 tokens
DIMS = dict(emb_size=20, depth=2, out_features=16)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _x(seed, n=B):
    return np.random.default_rng(seed).normal(size=(n, 1, C, T)).astype(np.float32)


def _perturbed_init(module, x, seed):
    """JAX's init with every parameter and running statistic moved off its
    init value (running variances in [0.5, 1.5))."""
    v = jax.tree.map(np.asarray, module.init(jax.random.key(seed), jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name:
            return (0.5 + rng.random(a.shape) if name.endswith("['var']")
                    else 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, v)


# ---------------------------------------------------------------- the data


@pytest.mark.parametrize("kw", [dict(seed=1, n_per_class=3, n_channels=5, n_samples=64),
                                dict(seed=2, n_per_class=2)], ids=["tiny", "bciiv_shape"])
def test_make_synthetic_bciiv_is_bit_equal(kw):
    for a, b in zip(trec.make_synthetic_bciiv(**kw), jrec.make_synthetic_bciiv(**kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_bciiv_mat_is_bit_equal(tmp_path):
    import scipy.io as sio

    rng = np.random.default_rng(3)
    for split, n in (("T", 12), ("E", 8)):
        sio.savemat(tmp_path / f"A03{split}.mat",
                    {"data": rng.normal(loc=1.0, scale=2.0, size=(50, 5, n)),
                     "label": np.tile(np.arange(1, 5), n // 4)[:, None]})
    got, want = trec.load_bciiv_mat(str(tmp_path), 3), jrec.load_bciiv_mat(str(tmp_path), 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- S&R


def _toy_corpus(seed=0, n_per_class=9, n_classes=4, C_=3, T_=40):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_per_class * n_classes, 1, C_, T_)).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), n_per_class).astype(np.int64)
    perm = rng.permutation(len(data))
    return data[perm], labels[perm]


@pytest.mark.parametrize("n_out,n_segments,seed", [(5, 8, 0), (3, 4, 1), (7, 8, 2)])
def test_interaug_gather_from_jax_draws_is_bit_equal(n_out, n_segments, seed):
    data, labels = _toy_corpus(seed)
    labels[labels == 3] = 2  # uneven classes: counts 9, 9, 18, and class 3 empty
    labels[0] = 3
    key = jax.random.key(seed)
    want_x, want_y = jrec.make_interaug(data, labels, 4, n_out, n_segments)(key)
    # JAX's own draws, as make_interaug takes them from the key
    table, counts = trec.interaug_table(labels, 4)
    k_idx, k_shuf = jax.random.split(key)
    idx = jax.random.randint(k_idx, (4, n_out, n_segments), 0,
                             jnp.asarray(counts, jnp.int32)[:, None, None])
    perm = jax.random.permutation(k_shuf, 4 * n_out)
    got_x, got_y = trec.interaug_gather(torch.from_numpy(data), torch.from_numpy(table),
                                        torch.from_numpy(np.asarray(idx, np.int64)),
                                        torch.from_numpy(np.asarray(perm, np.int64)))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_draw_interaug_stays_in_each_class():
    data, labels = _toy_corpus(4)
    table, counts = (torch.from_numpy(a) for a in trec.interaug_table(labels, 4))
    gen = torch.Generator().manual_seed(0)
    idx, perm = trec.draw_interaug(gen, counts, 6, 8)
    assert idx.shape == (4, 6, 8) and int(idx.min()) >= 0
    assert bool((idx < counts[:, None, None]).all())
    assert sorted(perm.tolist()) == list(range(24))
    aug, y = trec.interaug_gather(torch.from_numpy(data), table, idx, perm)
    seg = 40 // 8
    for i in range(len(aug)):
        same = data[labels == int(y[i])]
        for j in range(8):
            piece = aug[i, ..., j * seg:(j + 1) * seg].numpy()
            assert (same[..., j * seg:(j + 1) * seg] == piece).all(axis=(1, 2, 3)).any()
    again = trec.draw_interaug(torch.Generator().manual_seed(0), counts, 6, 8)
    assert torch.equal(again[0], idx) and torch.equal(again[1], perm)
    with pytest.raises(ValueError):
        trec.interaug_table(np.zeros(5, np.int64), 4)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_patch_embedding_matches_jax(fused, train):
    x = _x(5)
    jm = JaxPatchEmbedding(20, fused=fused)
    variables = _perturbed_init(jm, x, 6)
    tm = tconf.PatchEmbedding(C, 20, fused=fused)
    tm.load_state_dict(tconf.patch_embedding_from_jax(variables["params"],
                                                      variables["batch_stats"]))
    masks = DropoutMasks(7)
    with masks.intercept():
        want = jm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), masks.replay())
    assert got.shape == (B, 7, 20)
    _close(got, want)
    assert masks.drawn() == int(train)


def test_fused_patch_embedding_equals_the_conv_pair():
    x = torch.from_numpy(_x(8))
    fused = tconf.PatchEmbedding(C, 20, fused=True).eval()
    plain = tconf.PatchEmbedding(C, 20, fused=False).eval()
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=1e-5, atol=1e-5)


def _models(seed, dtype=None):
    jm = JaxConformer(**DIMS, dtype=dtype)
    variables = _perturbed_init(JaxConformer(**DIMS), _x(seed), seed)
    tm = tconf.Conformer(C, T, **DIMS, dtype={None: None, jnp.bfloat16: torch.bfloat16}[dtype])
    tm.load_state_dict(tconf.params_from_jax(variables, depth=DIMS["depth"]))
    return jm, variables, tm


def test_conformer_eval_forward_matches_jax():
    jm, variables, tm = _models(9)
    x = _x(10)
    want_flat, want_out = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        flat, out = tm.eval()(torch.from_numpy(x))
    assert flat.shape == (B, 7 * 20) and out.shape == (B, 16)
    _close(flat, want_flat)
    _close(out, want_out)


def test_conformer_train_forward_and_running_stats_match_jax():
    """Dropout in all 1 + 4·depth + 2 places from the same masks; the
    patch embedding's BatchNorm statistics after the step."""
    jm, variables, tm = _models(11)
    x = _x(12)
    masks = DropoutMasks(13)
    with masks.intercept():
        (want_flat, want_out), upd = jm.apply(variables, jnp.asarray(x), train=True,
                                              mutable=["batch_stats"])
    assert masks.drawn() == 1 + 4 * DIMS["depth"] + 2
    with torch.no_grad():
        flat, out = tm.train()(torch.from_numpy(x), masks.replay())
    _close(flat, want_flat)
    _close(out, want_out)
    new = tconf.params_from_jax({"params": variables["params"],
                                 "batch_stats": upd["batch_stats"]}, depth=DIMS["depth"])
    for k in ("patch_embedding.bn.running_mean", "patch_embedding.bn.running_var"):
        err = float((tm.state_dict()[k] - new[k]).abs().max())
        assert err <= TOL * float(new[k].abs().max()), (k, err)


def test_conformer_bf16_forward_matches_jax():
    """bf16 products and convolutions, f32 parameters, BatchNorm statistics,
    LayerNorm and softmax; the output in bf16 on both sides."""
    jm, variables, tm = _models(14, jnp.bfloat16)
    x = _x(15)
    want_flat, want_out = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        flat, out = tm.eval()(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and want_out.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _close(flat, want_flat, tol=3e-2)
    _close(out, want_out, tol=3e-2)


LR, STEPS = 2e-4, 5
# gradient zero in exact arithmetic: the keys' bias (softmax ignores a shift
# shared by all keys) and the biases ahead of the patch embedding's
# BatchNorm (train mode subtracts each channel's batch mean)
ZERO_GRAD = ("keys.bias", "patch_embedding.conv_0.bias", "patch_embedding.conv_1.bias")


def _assert_params(tm, params, what):
    """Adam divides each gradient by its own running scale, so where a
    gradient is mostly cancellation (or zero in exact arithmetic) the order
    of f32 sums moves its step by up to ~lr on each side. Every element is
    held to that bound, 2·STEPS·lr; at least 99.5 % of each tensor's elements
    (on the CPU 99.93 % of the worst tensor's, fc_1) to 1e-6, except the
    tensors whose whole gradient is zero in exact arithmetic."""
    no_stats = {"PatchEmbedding_0": {"BatchNorm_0": {"mean": np.zeros(40), "var": np.ones(40)}}}
    want = tconf.params_from_jax({"params": params, "batch_stats": no_stats},
                                 depth=DIMS["depth"])
    for name, p in tm.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert err.max() <= 2 * STEPS * LR, (what, name, err.max())
        if not name.endswith(ZERO_GRAD):
            assert (err <= 1e-6).mean() >= 0.995, (what, name, (err <= 1e-6).mean())


def test_five_adam_steps_match_jax():
    """Five steps of the recipe's step (dropout, Adam 2e-4 with betas (0.5,
    0.999), cross-entropy over the whole output against labels 0..3) from
    the same weights, batches and masks; the JAX step is jitted with the
    masks as arguments."""
    jm, variables, tm = _models(16)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    opt_state = tx.init(params)
    opt = torch.optim.Adam(tm.parameters(), lr=LR, betas=(0.5, 0.999), eps=1e-8)
    rng = np.random.default_rng(17)
    x_shape = (2 * B, 1, C, T)
    shapes = DropoutMasks(0)  # the masks' shapes and rates, from an abstract trace
    with shapes.intercept():
        jax.eval_shape(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]),
                       variables, jax.ShapeDtypeStruct(x_shape, jnp.float32))

    @jax.jit
    def jax_step(params, stats, opt_state, x, y, masks):
        def loss_fn(p):
            (_, out), upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                out.astype(jnp.float32), y).mean()
            return loss, upd["batch_stats"]

        with DropoutMasks(feed=masks).intercept():
            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    for step in range(STEPS):
        x = rng.normal(size=x_shape).astype(np.float32)
        y = rng.integers(0, 4, size=2 * B)
        masks = shapes.draw_again(100 + step)
        params, stats, opt_state, want = jax_step(params, stats, opt_state, jnp.asarray(x),
                                                  jnp.asarray(y, jnp.int32), masks)
        got = trec.conformer_step(tm, opt, torch.from_numpy(x), torch.from_numpy(y),
                                  replay(masks))
        assert abs(float(got) - float(want)) <= TOL * abs(float(want)), (step, got, want)
    _assert_params(tm, jax.tree.map(np.asarray, params), "after five steps")
    # the running variance; the running mean also carries the biases ahead
    # of the BatchNorm, whose steps are the noise of a zero gradient
    k = "patch_embedding.bn.running_var"
    want_var = tconf.params_from_jax({"params": params, "batch_stats": stats},
                                     depth=DIMS["depth"])[k]
    err = float((tm.state_dict()[k] - want_var).abs().max())
    assert err <= TOL * float(want_var.abs().max()), (k, err)


# ---------------------------------------------------------------- the CLI

TINY = ["--synthetic", "--subjects", "1", "--n_epochs", "8", "--batch_size", "16",
        "--depth", "1", "--emb_size", "20", "--out_features", "16",
        "--synthetic_per_class", "12", "--synthetic_channels", "6",
        "--synthetic_samples", "200", "--use_bf16", "false"]


def test_conformer_cli_end_to_end(tmp_path):
    """At the JAX CLI test's size: learns above chance (0.25) and writes the
    reference's log_subject1.txt and sub_result.txt, and the model as
    conformer_subject1.pt, which loads back."""
    results = cli.main(TINY + ["--device", "cpu", "--log_dir", str(tmp_path)])
    subject, best, aver = results[0]
    assert subject == 1 and best > 0.3 and 0.0 < aver <= best
    log = (tmp_path / "log_subject1.txt").read_text().splitlines()
    assert [line.split("    ")[0] for line in log[:8]] == [str(e) for e in range(8)]
    assert log[-1] == f"The best accuracy is: {best}"
    sub = (tmp_path / "sub_result.txt").read_text().splitlines()
    assert sub[0] == "Subject 1 : Seed is: 0"
    assert sub[1] == f"Subject 1 : The best accuracy is: {best}"
    assert sub[3] == f"**The average Best accuracy is: {np.mean([best])}"
    model = tconf.Conformer(6, 200, emb_size=20, depth=1, out_features=16)
    model.load_state_dict(torch.load(tmp_path / "conformer_subject1.pt", weights_only=True))


def test_conformer_cli_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TINY + ["--log_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # before any rank starts
        cli.main(TINY + ["--devices", "2", "--log_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "sub_result.txt")
