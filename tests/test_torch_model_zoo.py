"""The port's BatchNorm and the rest of the model zoo against the JAX package
on the CPU: flax's BatchNorm (the biased variance folded into the running
one, where torch's own module folds the unbiased one), the running
statistics of ResNet and XCiT after one train-mode forward, the
EEG-ChannelNet blocks (ConvLayer2D, TemporalBlock, SpatialBlock,
ResidualBlock) in eval and train mode with the same dropout masks on both
sides, CustomModel, and ResnetFeatureRegressor with init_feature_regressor's
torchvision graft.

Tolerances: running statistics 1e-5 relative to each tensor's largest
value (both sides fold f32 batch statistics by the same formula), except
after a whole ResNet-50 in train mode (1e-4 to the port's f64 evaluation,
1e-3 to JAX: see that test); outputs
1e-5 of the largest value, except ResNet-50's train mode, 1e-4 (flax takes
the batch variance in one pass, E[x²] − E[x]², torch in two: see
tests/test_torch_hub_backbones.py); bf16 BatchNorm outputs within one bf16
rounding (2^-7 relative); loaded weights exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from cerebra.models import layers as jlayers
from cerebra.models import resnet as jres
from cerebra.models import xcit as jxcit
from cerebra.models.mlp import CustomModel as JaxCustomModel
from cerebra_torch.models import layers as tlayers
from cerebra_torch.models import mlp as tmlp
from cerebra_torch.models import resnet as tres
from cerebra_torch.models import xcit as txcit
from cerebra_torch.models.batchnorm import BatchNorm1d, BatchNorm2d
from tests._flax_dropout import DropoutMasks

torch.set_num_threads(1)
TOL, TOL_TRAIN = 1e-5, 1e-4


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _rel(got, want, tol=TOL, what=""):
    got, want = got.detach().numpy(), np.asarray(want, dtype=np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _perturb(variables, seed):
    """Random parameters and running statistics (running variances in
    [0.5, 1.5)) on a flax tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, dtype=np.float32)
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name and name.endswith("['var']"):
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if "batch_stats" in name:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, dict(variables)))


def _running_stats_match(module: torch.nn.Module, want_sd: dict, what: str, tol=TOL):
    got = module.state_dict()
    names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert names, what
    for k in names:
        _rel(got[k], want_sd[k].numpy(), tol, what=f"{what} {k}")


# ----------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("shape", [(16, 8), (4, 6, 5, 3)], ids=["1d", "2d"])
def test_batchnorm_folds_the_biased_variance_like_flax(shape):
    """One train-mode step: flax's and the port's outputs and running
    statistics agree; torch's own module moves running_var by n/(n-1)
    times the batch variance's share."""
    rng = np.random.default_rng(1)
    x = (2.0 + 3.0 * rng.normal(size=shape)).astype(np.float32)
    C = shape[-1]
    params = {"scale": (1 + 0.2 * rng.normal(size=C)).astype(np.float32),
              "bias": (0.1 * rng.normal(size=C)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.normal(size=C)).astype(np.float32),
             "var": (0.5 + rng.random(C)).astype(np.float32)}
    want, upd = nn.BatchNorm(use_running_average=False, momentum=0.9).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"])
    new = upd["batch_stats"]

    def load(m):
        m.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                           "bias": torch.from_numpy(params["bias"]),
                           "running_mean": torch.from_numpy(stats["mean"]),
                           "running_var": torch.from_numpy(stats["var"]),
                           "num_batches_tracked": torch.tensor(0)})
        return m.train()

    xt = torch.from_numpy(x)
    if len(shape) == 2:
        port, stock, to_t, back = BatchNorm1d(C), torch.nn.BatchNorm1d(C, momentum=0.1), \
            (lambda t: t), (lambda t: t)
    else:
        port, stock = BatchNorm2d(C), torch.nn.BatchNorm2d(C, momentum=0.1)
        to_t, back = (lambda t: t.permute(0, 3, 1, 2)), (lambda t: t.permute(0, 2, 3, 1))
    with torch.no_grad():
        got = back(load(port)(to_t(xt)))
        load(stock)(to_t(xt))
    _close(got, want)
    _rel(port.running_mean, new["mean"])
    _rel(port.running_var, new["var"])
    assert int(port.num_batches_tracked) == 1
    n = x.size // C
    ratio = (stock.running_var - 0.9 * torch.from_numpy(stats["var"])) / \
        (port.running_var - 0.9 * torch.from_numpy(stats["var"]))
    np.testing.assert_allclose(ratio.numpy(), n / (n - 1), rtol=1e-4)


def test_batchnorm_bf16_keeps_f32_statistics_like_flax():
    rng = np.random.default_rng(2)
    x = (1.0 + rng.normal(size=(12, 6))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.bfloat16).init(
        jax.random.key(0), xb)
    want, upd = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.bfloat16).apply(
        variables, xb, mutable=["batch_stats"])
    port = BatchNorm1d(6).train()
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert port.running_var.dtype == torch.float32
    _close(got, np.asarray(want.astype(jnp.float32)), tol=2 ** -7)
    _rel(port.running_mean, upd["batch_stats"]["mean"])
    _rel(port.running_var, upd["batch_stats"]["var"])


def test_batchnorm_eval_mode_uses_the_running_statistics():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 4, 3, 7)).astype(np.float32)
    variables = _perturb(nn.BatchNorm(use_running_average=True).init(
        jax.random.key(0), jnp.zeros((1, 3, 7, 4))), 4)
    want = nn.BatchNorm(use_running_average=True).apply(variables, jnp.asarray(x).transpose(
        0, 2, 3, 1))
    port = BatchNorm2d(4)
    p, s = variables["params"], variables["batch_stats"]
    port.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                          "bias": torch.from_numpy(p["bias"]),
                          "running_mean": torch.from_numpy(s["mean"]),
                          "running_var": torch.from_numpy(s["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got.permute(0, 2, 3, 1), want)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


XCIT_DIMS = dict(embed_dim=32, depth=2, num_heads=4, eta=1.0)


def _resnet_case():
    stages = (1, 1, 1, 1)
    jm = jres.ResNet(stages)
    x = np.random.default_rng(5).normal(size=(4, 32, 32, 3)).astype(np.float32)
    variables = _perturb(jm.init(jax.random.key(0), jnp.asarray(x), train=False), 6)
    tm = tres.ResNet(stages)
    return jm, tm, x, variables, (lambda v: tres.params_from_jax(v, stages)), {"train": True}


def _xcit_case():
    jm = jxcit.XCiT(patch_size=16, **XCIT_DIMS)
    x = np.random.default_rng(7).normal(size=(3, 32, 32, 3)).astype(np.float32)
    variables = _perturb(jm.init(jax.random.key(1), jnp.asarray(x)), 8)
    tm = txcit.XCiT(patch_size=16, **XCIT_DIMS)
    return jm, tm, x, variables, (lambda v: txcit.params_from_jax(v, depth=2, patch_size=16)), \
        {"train": True}


@pytest.mark.parametrize("case", [_resnet_case, _xcit_case], ids=["resnet", "xcit"])
def test_running_stats_after_a_train_step_match_jax(case):
    """One train-mode forward with mutable batch_stats: every running mean
    and variance of the port equals JAX's new batch_stats."""
    jm, tm, x, variables, to_torch, kw = case()
    tm.load_state_dict(to_torch(variables))
    _, upd = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"], **kw)
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    want = to_torch({"params": variables["params"], "batch_stats": upd["batch_stats"]})
    _running_stats_match(tm, want, case.__name__)


# -------------------------------------------------------- EEG-ChannelNet blocks

X_BLOCKS = (2, 16, 40, 4)  # NHWC


def _block_cases():
    return {
        "conv_layer": (jlayers.ConvLayer2D(8, (3, 5), (1, 2), (1, 2), (1, 1)),
                       tlayers.ConvLayer2D(4, 8, (3, 5), (1, 2), (1, 2), (1, 1)),
                       "ConvLayer2D", True),
        "temporal": (jlayers.TemporalBlock(8, 3, (1, 5), (1, 2), [(1, 1), (1, 2)]),
                     tlayers.TemporalBlock(4, 8, 3, (1, 5), (1, 2), [(1, 1), (1, 2)]),
                     "TemporalBlock", True),
        "spatial": (jlayers.SpatialBlock(8, 3, (2, 1), 16),
                    tlayers.SpatialBlock(4, 8, 3, (2, 1), 16), "SpatialBlock", True),
        "residual": (jlayers.ResidualBlock(4), tlayers.ResidualBlock(4, 4), "ResidualBlock",
                     False),
        "residual_down": (jlayers.ResidualBlock(8, (2, 2)), tlayers.ResidualBlock(4, 8, (2, 2)),
                          "ResidualBlock", False),
    }


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(_block_cases()))
def test_channelnet_blocks_match_jax(name, train):
    jm, tm, kind, has_dropout = _block_cases()[name]
    x = np.random.default_rng(9).normal(size=X_BLOCKS).astype(np.float32)
    variables = _perturb(jm.init(jax.random.key(2), jnp.asarray(x), train=False), 10)
    tm.load_state_dict(tlayers.params_from_jax(kind, variables))
    masks = DropoutMasks(11)
    if train:
        with masks.intercept():
            want, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    tm.train(train)
    args = (masks.replay(),) if has_dropout else ()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *args)
    _close(got, want, what=name)
    if train:
        assert masks.drawn() == (len(tm.layers) if has_dropout and kind != "ConvLayer2D"
                                 else int(has_dropout))
        new = tlayers.params_from_jax(kind, {"params": variables["params"],
                                             "batch_stats": upd["batch_stats"]})
        _running_stats_match(tm, new, name)


def test_temporal_padding_keeps_the_reference_rule():
    for width in (3, 5, 7):
        for d in (1, 2, 3, 4):
            f = width * d - 1
            assert tlayers.temporal_padding(width, d) == (f - 1) // 2 - (d // 2 - 1)


# ------------------------------------------------------------ CustomModel


def test_custom_model_matches_jax():
    x = np.random.default_rng(12).normal(size=(3, 10)).astype(np.float32)
    jm = JaxCustomModel(output_size=12, hidden=16)
    params = _perturb(jm.init(jax.random.key(3), jnp.asarray(x)), 13)["params"]
    tm = tmlp.CustomModel(10, 12, hidden=16)
    tm.load_state_dict(tmlp.params_from_jax(params))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))
    fresh = tmlp.CustomModel(10, 12, hidden=2000, generator=torch.Generator().manual_seed(0))
    # flax's lecun_normal: std 1/sqrt(fan_in), a normal truncated at ±2 of
    # its own scale (1/sqrt(fan_in)/0.8796)
    w = fresh.fc_1.weight.detach().numpy()
    assert abs(w.std() * np.sqrt(2000) - 1.0) < 0.02
    assert np.abs(w).max() <= 2 / np.sqrt(2000) / 0.87962566
    assert not fresh.fc_1.bias.any()


# --------------------------------------------------- ResnetFeatureRegressor


@pytest.fixture(scope="module")
def regressor_case(tmp_path_factory):
    """A random torchvision-layout resnet50 .pth grafted by both packages'
    init_feature_regressor (32 px, 10 outputs)."""
    src = tres.resnet50(generator=torch.Generator().manual_seed(14))
    g = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for name, b in src.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
            elif name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
        for name, p in src.named_parameters():
            if ".bn" in name or name.startswith("bn") or "downsample.1" in name:
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
    path = str(tmp_path_factory.mktemp("regressor") / "resnet50.pth")
    torch.save(src.state_dict(), path)
    jm, variables = jres.init_feature_regressor(jax.random.key(4), 10, path, image_size=32)
    variables = jax.tree.map(np.asarray, variables)
    tm = tres.init_feature_regressor(10, path, generator=torch.Generator().manual_seed(16))
    return src, jm, variables, tm


def test_init_feature_regressor_grafts_the_backbone_like_jax(regressor_case):
    src, _, variables, tm = regressor_case
    for k, v in src.state_dict().items():
        assert torch.equal(tm.backbone.state_dict()[k], v), k
    carried = tres.regressor_params_from_jax(variables)
    for k, v in tm.backbone.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(carried["backbone." + k], v), k
    assert tuple(tm.fc.weight.shape) == (10, 2048) and not tm.fc.bias.any()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_feature_regressor_matches_jax(regressor_case, train):
    """Eval mode to 1e-5 and train mode to 1e-4, at 64 px and B = 8. Through
    the 53 BatchNorms of a ResNet-50 in train mode f32 itself drifts: the
    port's running statistics lie 2.1e-5 from its own f64 evaluation and
    JAX's 1.5e-4 (its one-pass batch variance; measured on this input). So
    they are held to the f64 evaluation at 1e-4 and to JAX at 1e-3; the
    1e-5 check of the fold itself is the shallow ResNet above."""
    _, jm, variables, _ = regressor_case
    carried = tres.regressor_params_from_jax(variables)
    tm = tres.ResnetFeatureRegressor(10)
    tm.load_state_dict(carried)
    x = np.random.default_rng(17 + train).normal(size=(8, 64, 64, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=train, mutable=["batch_stats"]))
    want, upd = apply(variables, jnp.asarray(x))
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want, tol=TOL_TRAIN if train else TOL)
    if train:
        f64 = tres.ResnetFeatureRegressor(10).double()
        f64.load_state_dict(carried)
        with torch.no_grad():
            f64.train()(torch.from_numpy(x).double())
        new = tres.regressor_params_from_jax({"params": variables["params"],
                                              "batch_stats": upd["batch_stats"]})
        truth = {k: v.float() for k, v in f64.state_dict().items()}
        _running_stats_match(tm, truth, "regressor against f64", tol=1e-4)
        _running_stats_match(tm, new, "regressor against JAX", tol=1e-3)
