"""The port imports on a machine without JAX: importing `cerebra_torch` and
every one of its modules pulls in neither `jax` nor the `cerebra` package,
and among them are the ported CLIs, the launcher, the parallel package, the
spans, and the ingest, signal-analysis, corpus and t-SNE modules;
nor does it pull in scikit-learn, matplotlib or mne, which the GPU machine
lacks."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import importlib, pkgutil, sys
import cerebra_torch
names = [m.name for m in pkgutil.walk_packages(cerebra_torch.__path__, "cerebra_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cerebra"))
assert not bad, bad
assert "cerebra_torch.cli.lstm_distill_from_dinov2_train" in names
assert "cerebra_torch.cli.main_dino" in names
assert "cerebra_torch.models.autoencoders" in names
assert "cerebra_torch.models.lstm_scan" in names
for cli in ("discover_channels", "save_channelwise_outputs", "brain_map", "eeg_retrieval_dino",
            "visualize_attention", "extract_features", "noise_probe"):
    assert "cerebra_torch.cli." + cli in names, cli
for mod in ("data.gauss_noise", "data.sources", "signal.image_aug", "models.xcit",
            "models.resnet", "models.hub"):
    assert "cerebra_torch." + mod in names, mod
for mod in ("parallel", "parallel.mesh", "parallel.collectives", "parallel.dataflow",
            "parallel.tp", "cli.launch", "utils.spans"):
    assert "cerebra_torch." + mod in names, mod
for mod in ("cli.convert_to_pth", "cli.get_tsne_for_raw_eeg", "data.bdf", "data.ingest",
            "data.native_bdf", "data.labelwise", "data.transforms", "signal.psd",
            "signal.denoise", "signal.mne_compat", "utils.native_build", "eval.native_topk",
            "eval.faiss_stub", "eval.tsne"):
    assert "cerebra_torch." + mod in names, mod
for lazy in ("PIL", "torchvision", "transformers", "sklearn", "matplotlib", "mne"):
    assert lazy not in sys.modules, lazy
print(len(names))
"""


def test_port_imports_without_jax_or_cerebra():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30
