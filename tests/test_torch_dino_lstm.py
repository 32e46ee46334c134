"""The port's DINO-LSTM slice (lstm_distillation) against the JAX package on
the CPU: three DINO steps of `make_dino_step` over the LSTM backbone from the
same weights and views (f32: losses, center, student and teacher compared),
the reference `.pth` checkpoint in both directions with its AdamW moments (a
JAX export resumed in the port and a port export resumed in JAX, each then
taking the third step against the other package's), with the weight-norm
gain frozen and trained; lazy and partial reference optimizer state; the
auto-resume files and the recipe's two resumes.

Tolerances: the loss and center to 1e-5 and the parameters to 2e-5 after
three AdamW steps, as `test_torch_dino_vit_train.py` (updates of ~1e-3
whose gradients differ only in the order of f32 sums); moments read back
from a checkpoint exactly (f32 copies)."""

import copy
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.heads import DINOHead as JaxHead
from cerebra.models.lstm import Model as JaxModel
from cerebra.train import checkpoints as jck
from cerebra.train.steps import DinoTrainState as JaxState
from cerebra.train.steps import make_dino_step as jax_make_dino_step
from cerebra.train.steps import make_scheduled_optimizer as jax_scheduled_optimizer
from cerebra_torch.models import heads, lstm
from cerebra_torch.models.multicrop import MultiCropWrapper
from cerebra_torch.train import checkpoints as tck
from cerebra_torch.train.recipes import (
    DinoSelfDistillConfig,
    build_dino_models,
    dino_selfdistill_train,
    dino_state_dict,
)
from cerebra_torch.train import recipes
from cerebra_torch.train.resume import AutoResume, PreemptionGuard
from cerebra_torch.train.schedules import cosine_scheduler
from cerebra_torch.train.steps import DinoTrainState, make_dino_step, make_scheduled_optimizer

torch.set_num_threads(1)

C, E, L, OUT, B, TG, TL = 6, 8, 2, 16, 3, 12, 8
NITER, EPOCHS = 2, 2
LR = cosine_scheduler(1e-3, 1e-4, EPOCHS, NITER, warmup_epochs=0)
WD = cosine_scheduler(0.04, 0.4, EPOCHS, NITER)
MOM = cosine_scheduler(0.9, 1.0, EPOCHS, NITER)
TEMPS = np.array([0.04, 0.07])


def _jax_params(norm_last_layer):
    jb = JaxModel(input_size=C, lstm_size=E, lstm_layers=L, output_size=E, include_top=False,
                  input_grad=False)
    jh = JaxHead(in_dim=E, out_dim=OUT, hidden_dim=32, bottleneck_dim=8,
                 norm_last_layer=norm_last_layer)
    bp = jb.init(jax.random.key(0), jnp.zeros((1, TG, C)), features_only=True)["params"]
    hp = jh.init(jax.random.key(1), jnp.zeros((1, E)))["params"]
    return jb, jh, jax.tree.map(np.asarray, {"backbone": bp, "head": hp})


def _state_dict(params):
    sd = {f"backbone.{k}": v for k, v in lstm.params_from_jax(params["backbone"]).items()}
    sd.update({f"head.{k}": v for k, v in heads.params_from_jax(params["head"]).items()})
    return sd


def _port_state(params, norm_last_layer, seed=0):
    cfg = DinoSelfDistillConfig(embed_dim=E, lstm_layers=L, out_dim=OUT,
                                norm_last_layer=norm_last_layer)
    backbone, _ = build_dino_models(C, cfg, torch.Generator().manual_seed(seed))
    head = heads.DINOHead(E, OUT, hidden_dim=32, bottleneck_dim=8,
                          norm_last_layer=norm_last_layer,
                          generator=torch.Generator().manual_seed(seed))
    student = MultiCropWrapper(backbone, head).train()
    if params is not None:
        student.load_state_dict(_state_dict(params), strict=True)
    teacher = copy.deepcopy(student).eval()
    for p in teacher.parameters():
        p.requires_grad_(False)
    return DinoTrainState(step=0, student=student, teacher=teacher,
                          optimizer=make_scheduled_optimizer("adamw", student, LR, WD, 3.0),
                          center=torch.zeros(1, OUT))


def _jax_step(jb, jh, tx):
    return jax_make_dino_step(
        backbone_apply=lambda p, x: jb.apply(p, x, features_only=True),
        head_apply=lambda p, f: jh.apply(p, f), tx=tx,
        lr_schedule=jnp.asarray(LR, jnp.float32), wd_schedule=jnp.asarray(WD, jnp.float32),
        momentum_schedule=jnp.asarray(MOM, jnp.float32),
        teacher_temp_by_epoch=jnp.asarray(TEMPS, jnp.float32), niter_per_ep=NITER,
        view_fn=lambda key, batch: [jnp.asarray(v) for v in batch], freeze_last_layer=1,
    )


def _assert_params(model, params, atol, what):
    want = _state_dict(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{what} {name}")


def _views(seed):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(2, B, TG, C)).astype(np.float32),
             rng.normal(size=(4, B, TL, C)).astype(np.float32)] for _ in range(3)]


def _port_moments(state):
    inner = state.optimizer.inner.state
    return {n: (inner[p]["exp_avg"].numpy().copy(), inner[p]["exp_avg_sq"].numpy().copy())
            for n, p in state.student.named_parameters() if p.requires_grad}


def _jax_moments(opt_state):
    """Copies: the JAX step donates its state, and np.asarray would view it."""
    adam = jck._find_adam_state(opt_state)
    mu = jck.wrapped_to_torch_state_dict(jax.tree.map(np.array, adam.mu))
    nu = jck.wrapped_to_torch_state_dict(jax.tree.map(np.array, adam.nu))
    return {k: (mu[k], nu[k]) for k in mu}, int(np.asarray(adam.count))


@pytest.mark.parametrize("norm_last_layer", [True, False], ids=["frozen_gain", "trained_gain"])
def test_three_dino_lstm_steps_match_jax_and_resume_across_packages(norm_last_layer, tmp_path):
    views = _views(int(norm_last_layer))
    jb, jh, params = _jax_params(norm_last_layer)
    tx = jax_scheduled_optimizer("adamw", LR, WD, params_mask_source=params, clip_grad=3.0)
    jstep = _jax_step(jb, jh, tx)
    jstate = JaxState(step=jnp.zeros([], jnp.int32), student_params=jax.tree.map(jnp.asarray, params),
                      teacher_params=jax.tree.map(jnp.asarray, params),
                      opt_state=tx.init(jax.tree.map(jnp.asarray, params)),
                      center=jnp.zeros((1, OUT)))
    state = _port_state(params, norm_last_layer)
    step = make_dino_step(LR, WD, MOM, TEMPS, NITER,
                          view_fn=lambda gen, batch: [torch.from_numpy(v) for v in batch],
                          freeze_last_layer=1)
    jax_pth, port_pth = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    kw = dict(lr=5e-4, weight_decay=0.04, norm_last_layer=norm_last_layer)
    for i in range(3):
        if i == 2:  # both packages write the reference checkpoint after two steps
            jax_moments, jax_count = _jax_moments(jstate.opt_state)
            jck.export_dino_pth(jax_pth, jax.tree.map(np.array, jstate.student_params),
                                jax.tree.map(np.array, jstate.teacher_params),
                                np.array(jstate.center), 0,
                                opt_state=jax.tree.map(np.array, jstate.opt_state), **kw)
            tck.export_dino_pth(port_pth, state.student, state.teacher, state.center, 0,
                                optimizer=state.optimizer, **kw)
            port_moments = _port_moments(state)
        jstate, jm = jstep(jstate, views[i], jax.random.key(i))
        state, m = step(state, views[i])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center), atol=1e-5)
    _assert_params(state.student, jstate.student_params, 2e-5, "student")
    _assert_params(state.teacher, jstate.teacher_params, 2e-5, "teacher")

    # JAX's checkpoint, resumed in the port: moments exact, then step 3 as JAX's
    resumed = _port_state(None, norm_last_layer, seed=5)
    _, _, center, epoch = tck.import_dino_pth(jax_pth, resumed.student, resumed.teacher,
                                              resumed.optimizer)
    assert epoch == 1 and resumed.optimizer.count == jax_count == 2
    for name, (mu, nu) in _port_moments(resumed).items():
        np.testing.assert_array_equal(mu, jax_moments[name][0], err_msg=name)
        np.testing.assert_array_equal(nu, jax_moments[name][1], err_msg=name)
    resumed.step, resumed.center = 2, center
    resumed, m = step(resumed, views[2])
    _assert_params(resumed.student, jstate.student_params, 2e-5, "resumed student")
    _assert_params(resumed.teacher, jstate.teacher_params, 2e-5, "resumed teacher")

    # the port's checkpoint, resumed in JAX: moments exact, then step 3 as the port's
    template = tx.init(jax.tree.map(jnp.asarray, params))
    student, teacher, center, epoch, opt_state = jck.import_dino_pth(
        port_pth, opt_state_template=template)
    moments, count = _jax_moments(opt_state)
    assert epoch == 1 and count == 2
    for name, (mu, nu) in port_moments.items():
        np.testing.assert_array_equal(moments[name][0], mu, err_msg=name)
        np.testing.assert_array_equal(moments[name][1], nu, err_msg=name)
    jresumed = JaxState(step=jnp.asarray(2, jnp.int32),
                        student_params=jax.tree.map(jnp.asarray, student),
                        teacher_params=jax.tree.map(jnp.asarray, teacher), opt_state=opt_state,
                        center=jnp.asarray(center))
    jresumed, _ = jstep(jresumed, views[2], jax.random.key(2))
    _assert_params(state.student, jresumed.student_params, 2e-5, "JAX-resumed student")
    _assert_params(state.teacher, jresumed.teacher_params, 2e-5, "JAX-resumed teacher")


@pytest.mark.parametrize("norm_last_layer", [True, False], ids=["frozen_gain", "trained_gain"])
def test_checkpoint_layout_and_ids_match_jax(norm_last_layer, tmp_path):
    """The port's export holds the JAX export's keys and shapes, and its
    optimizer ids name the same parameters in the same groups (weight_g
    before weight_v, the frozen gain left out)."""
    _, _, params = _jax_params(norm_last_layer)
    tx = jax_scheduled_optimizer("adamw", LR, WD, params_mask_source=params, clip_grad=3.0)
    jck.export_dino_pth(str(tmp_path / "j.pth"), params, params, np.zeros((1, OUT), np.float32),
                        3, opt_state=tx.init(params), norm_last_layer=norm_last_layer)
    state = _port_state(params, norm_last_layer)
    tck.export_dino_pth(str(tmp_path / "p.pth"), state.student, state.teacher, state.center, 3,
                        optimizer=state.optimizer, norm_last_layer=norm_last_layer)
    want = torch.load(str(tmp_path / "j.pth"), weights_only=False)
    got = torch.load(str(tmp_path / "p.pth"), weights_only=False)
    assert got["epoch"] == want["epoch"] == 4
    for slot in ("student", "teacher"):
        assert {k: tuple(v.shape) for k, v in got[slot].items()} == \
            {k: tuple(v.shape) for k, v in want[slot].items()}
    assert [g["params"] for g in got["optimizer"]["param_groups"]] == \
        [g["params"] for g in want["optimizer"]["param_groups"]]
    assert [g["weight_decay"] for g in got["optimizer"]["param_groups"]] == [0.04, 0.0]
    names = [k for g in tck._grouped_param_names(
        {k[len("module."):]: tuple(v.shape) for k, v in got["student"].items()},
        norm_last_layer) for k in g]
    assert names == [k for g in jck._grouped_param_names(
        {k[len("module."):]: v.numpy() for k, v in want["student"].items()},
        norm_last_layer) for k in g]
    assert ("head.last_layer.weight_g" in names) != norm_last_layer
    assert names.index("head.last_layer.weight_v") > names.index("head.mlp.4.weight")


def test_lazy_and_partial_reference_state_import_like_jax(tmp_path):
    """A reference run's optimizer slot without entries for the cancelled
    last layer (torch's lazy state) and with per-parameter steps that
    differ: the port keeps zero moments there and takes the largest step,
    as JAX's adamw_state_from_torch does."""
    _, _, params = _jax_params(True)
    tx = jax_scheduled_optimizer("adamw", LR, WD, params_mask_source=params, clip_grad=3.0)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
                         params)
    opt_state = tx.init(params)
    for _ in range(3):
        _, opt_state = tx.update(grads, opt_state, jax.tree.map(jnp.asarray, params))
    path = str(tmp_path / "ref.pth")
    jck.export_dino_pth(path, params, params, np.zeros((1, OUT), np.float32), 0,
                        opt_state=jax.tree.map(np.asarray, opt_state))
    ckpt = torch.load(path, weights_only=False)
    sd_names = [k for g in jck._grouped_param_names(
        {k[len("module."):]: v.numpy() for k, v in ckpt["student"].items()}) for k in g]
    lazy = sd_names.index("head.last_layer.weight_v")
    del ckpt["optimizer"]["state"][lazy]
    ckpt["optimizer"]["state"][0]["step"] = torch.tensor(1.0)
    torch.save(ckpt, path)

    state = _port_state(params, True)
    tck.import_dino_pth(path, state.student, state.teacher, state.optimizer)
    assert state.optimizer.count == 3
    _, _, _, _, jopt = jck.import_dino_pth(path, opt_state_template=tx.init(params))
    want, count = _jax_moments(jopt)
    assert count == 3
    got = _port_moments(state)
    assert not got["head.last_layer.weight_v"][0].any()
    for name, (mu, nu) in got.items():
        np.testing.assert_array_equal(mu, want[name][0], err_msg=name)
        np.testing.assert_array_equal(nu, want[name][1], err_msg=name)
    steps = {float(s["step"]) for s in state.optimizer.inner.state.values()}
    assert steps == {3.0}


@pytest.fixture
def signal_handlers():
    """The preemption handler is process-wide: put the old ones back."""
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    yield
    for s, h in old.items():
        signal.signal(s, h)


def test_auto_resume_keeps_the_newest_three_and_restores_the_latest(tmp_path, signal_handlers):
    resume = AutoResume(str(tmp_path / "r"), keep=3)
    assert resume.restore_latest() == (None, None)
    for step in (4, 8, 12, 16):
        resume.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert sorted(os.listdir(resume.directory)) == [f"step_{s:010d}.pt" for s in (8, 12, 16)]
    step, tree = resume.restore_latest()
    assert step == 16 and tree["step"] == 16 and torch.equal(tree["w"], torch.full((2,), 16.0))

    saved = []
    with PreemptionGuard() as guard:
        guard.exit_if_requested(lambda: saved.append(resume.save(20, {"step": 20})))
        assert not saved  # no signal yet
        signal.raise_signal(signal.SIGUSR1)  # only recorded
        assert guard.signum == signal.SIGUSR1 and not saved
        with pytest.raises(SystemExit):
            guard.exit_if_requested(lambda: saved.append(resume.save(20, {"step": 20})))
    assert saved and resume.latest_step() == 20


def test_recipe_auto_resumes_and_resumes_from_pth(tmp_path, signal_handlers):
    """A two-epoch run whose last step file is then removed, run again: the
    auto-resume restores step 2 and runs epoch 1 alone, and ends where the
    first run ended (an epoch's crops come from (seed, epoch)). `resume_pth`
    starts at the checkpoint's epoch, the optimizer's count at its step."""
    eeg = np.random.default_rng(0).normal(size=(4, 20, C)).astype(np.float32)
    cfg = DinoSelfDistillConfig(epochs=2, batch_size_per_device=2, out_dim=OUT, embed_dim=E,
                                lstm_layers=L, global_length=12, local_length=8, n_local=2,
                                warmup_epochs=1)
    cpu = torch.device("cpu")
    pth = str(tmp_path / "checkpoint.pth")

    def checkpoint_cb(epoch, st):
        if epoch == 0:
            tck.export_dino_pth(pth, st.student, st.teacher, st.center, epoch,
                                optimizer=st.optimizer)

    resume = AutoResume(str(tmp_path / "resume"))
    full, h1 = dino_selfdistill_train(eeg, cpu, cfg, log_fn=lambda m: None, resume=resume,
                                      checkpoint_cb=checkpoint_cb)
    assert len(h1["loss"]) == 2 and resume._steps() == [2, 4]
    os.remove(resume._path(4))
    again, h2 = dino_selfdistill_train(eeg, cpu, cfg, log_fn=lambda m: None, resume=resume)
    assert len(h2["loss"]) == 1 and again.step == 4 and resume.latest_step() == 4
    assert h2["loss"][0] == pytest.approx(h1["loss"][1], abs=1e-6)
    want = dino_state_dict(full)
    for part in ("student", "teacher"):
        for k, v in dino_state_dict(again)[part].items():
            np.testing.assert_allclose(v.numpy(), want[part][k].numpy(), atol=1e-6)
    restarted, h3 = dino_selfdistill_train(eeg, cpu, cfg, log_fn=lambda m: None, resume_pth=pth)
    assert len(h3["loss"]) == 1 and restarted.step == 4 and restarted.optimizer.count == 4
    assert h3["loss"][0] == pytest.approx(h1["loss"][1], abs=1e-6)


def test_preemption_inside_a_step_saves_at_the_step_boundary(tmp_path, monkeypatch,
                                                               signal_handlers):
    """SIGUSR1 raised between the third step's optimizer update and its
    teacher EMA: the run finishes that step, saves step 3 and exits, with
    the previous handler back in place. Resumed, it takes the fourth step
    alone and ends where an unbroken run ends, so the saved student and
    teacher were a step boundary's."""
    eeg = np.random.default_rng(0).normal(size=(4, 20, C)).astype(np.float32)
    cfg = DinoSelfDistillConfig(epochs=2, batch_size_per_device=2, out_dim=OUT, embed_dim=E,
                                lstm_layers=L, global_length=12, local_length=8, n_local=2,
                                warmup_epochs=1)
    cpu = torch.device("cpu")
    full, _ = dino_selfdistill_train(eeg, cpu, cfg, log_fn=lambda m: None)
    real = recipes.make_dino_lstm

    def interrupted(*args, **kwargs):
        state, step, niter = real(*args, **kwargs)
        opt_step = state.optimizer.step

        def step_then_signal():
            opt_step()
            if state.optimizer.count == 3:
                signal.raise_signal(signal.SIGUSR1)

        state.optimizer.step = step_then_signal
        return state, step, niter

    monkeypatch.setattr(recipes, "make_dino_lstm", interrupted)
    resume = AutoResume(str(tmp_path / "resume"))
    before = signal.getsignal(signal.SIGUSR1)
    with pytest.raises(SystemExit):
        dino_selfdistill_train(eeg, cpu, cfg, log_fn=lambda m: None, resume=resume)
    assert signal.getsignal(signal.SIGUSR1) is before
    assert resume._steps() == [2, 3]
    monkeypatch.undo()
    again, h = dino_selfdistill_train(eeg, cpu, cfg, log_fn=lambda m: None, resume=resume)
    assert again.step == 4 and len(h["loss"]) == 1 and resume.latest_step() == 4
    want = dino_state_dict(full)
    for part in ("student", "teacher"):
        for k, v in dino_state_dict(again)[part].items():
            np.testing.assert_allclose(v.numpy(), want[part][k].numpy(), atol=1e-6)
    np.testing.assert_allclose(again.center.numpy(), full.center.numpy(), atol=1e-6)
