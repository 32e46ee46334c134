"""BDF ingest in the port against cerebra/data/ingest.py and its CLI: the
numpy reader and writer, the native reader, `convert_bdf_to_pth` on a small
recording with the filters on the CPU (filtfilt_fft and the exact
filtfilt), the .pth read both ways, and `convert_to_pth` against the JAX
CLI."""

import pickle

import numpy as np
import pytest
import torch

from cerebra.cli.convert_to_pth import main as jax_convert_main
from cerebra.data import bdf as jbdf
from cerebra.data import ingest as jingest
from cerebra.data.schema import load_corpus_pth as jax_load_pth
from cerebra.data.schema import save_corpus_pth as jax_save_pth
from cerebra_torch.cli.convert_to_pth import main as convert_main
from cerebra_torch.data import bdf, ingest, native_bdf
from cerebra_torch.data.schema import RawCorpus, load_corpus_pth, save_corpus_pth

torch.set_num_threads(1)

N_EVENTS = 8


def _recording(tmp_path, n_eeg=8, fs=256, seconds=30, n_events=N_EVENTS + 1):
    """tests/test_ingest.py::_make_recording: EEG + two EXG channels and a
    Status channel with `n_events` trigger words, written by the port."""
    rng = np.random.default_rng(0)
    T = fs * seconds
    names = [f"A{i+1}" for i in range(n_eeg)] + ["EXG1", "EXG2"]
    sig = rng.normal(0, 20.0, size=(len(names), T)).astype(np.float32)
    status = np.zeros(T, dtype=np.int64)
    for s in np.linspace(fs, T - fs * 3, n_events).astype(int):
        status[s:s + 10] = ingest.STATUS_EVENT
    path = str(tmp_path / "rec.bdf")
    bdf.write_raw_bdf(path, sig, names, fs, status=status)
    return path, sig, names, status


def _tables(tmp_path, n=N_EVENTS):
    wnids = ["n01000001", "n01000002"]
    mapping = {f"{wnids[i % 2]}_{i:04d}": i % 2 for i in range(n)}
    mfile, sfile = str(tmp_path / "image.pkl"), str(tmp_path / "seq.txt")
    with open(mfile, "wb") as f:
        pickle.dump(mapping, f)
    with open(sfile, "w") as f:
        f.writelines(k + ".JPEG\n" for k in mapping)
    return mfile, sfile


def test_bdf_writer_and_readers_match_jax(tmp_path):
    path, sig, names, status = _recording(tmp_path)
    jpath = str(tmp_path / "jax.bdf")
    jbdf.write_raw_bdf(jpath, sig, names, 256, status=status)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    got, want = bdf.read_raw_bdf(path), jbdf.read_raw_bdf(path)
    assert got.channel_names == want.channel_names == names + ["Status"]
    assert got.sample_rate == want.sample_rate == 256.0
    np.testing.assert_array_equal(got.signals, want.signals)
    np.testing.assert_array_equal(got.status, want.status)
    if not native_bdf.available():
        pytest.skip("no C++ toolchain for the native reader")
    nat = native_bdf.read_raw_bdf(path)
    assert nat.channel_names == got.channel_names and nat.sample_rate == got.sample_rate
    np.testing.assert_array_equal(nat.signals, got.signals)
    np.testing.assert_array_equal(nat.status, got.status)


def test_native_library_is_built_under_the_port_build_dir():
    from cerebra_torch.utils import native_build

    if not native_bdf.available():
        pytest.skip("no C++ toolchain for the native reader")
    path = native_build.library_path(native_bdf._SRC)
    assert path.startswith(native_build.BUILD_DIR) and path.endswith(".so")
    assert "bdf_reader-" in path
    assert native_build.build_and_load(native_bdf._SRC) is not None


@pytest.mark.parametrize("apply_bandpass,use_fft,notch", [
    (False, True, False), (True, True, False), (True, False, False), (True, True, True),
    (False, False, True),
], ids=["raw", "fft", "exact", "fft+notch", "notch_only_exact"])
def test_convert_bdf_to_pth_matches_jax(tmp_path, apply_bandpass, use_fft, notch):
    """The payload against JAX's on the same recording: eeg (and the stats
    computed from it) to 1e-5 of the peak (the f32 filters' rounding; equal
    to the bit without a filter), labels, names, wnids and subjects exact."""
    path, *_ = _recording(tmp_path)
    mfile, sfile = _tables(tmp_path)
    kw = dict(subject=3, sequence_file=sfile, mappings_file=mfile, reference_channels=(0, 1),
              apply_bandpass=apply_bandpass, band=(4.0, 40.0), apply_notch=notch,
              notch_freq=30.0, bad_channels=("EXG1", "EXG2", "Status"),
              expected_samples=N_EVENTS, use_device_filters=use_fft)
    stages = {}
    got = ingest.convert_bdf_to_pth(path, str(tmp_path / "t.pth"), device="cpu",
                                    stage_seconds=stages, **kw)
    want = jingest.convert_bdf_to_pth(path, str(tmp_path / "j.pth"), **kw)
    assert set(stages) == {"read", "resample", "filter", "epochs", "write"}
    assert got.eeg.shape == want.eeg.shape == (N_EVENTS, 8, 32)
    peak = np.abs(want.eeg).max()
    tol = 1e-5 if apply_bandpass or notch else 0.0
    assert np.abs(got.eeg - want.eeg).max() <= tol * peak
    np.testing.assert_allclose(got.means, want.means, rtol=0, atol=tol * peak)
    np.testing.assert_allclose(got.stddevs, want.stddevs, rtol=tol * 10, atol=tol * peak)
    for field in ("labels", "image_idx", "subjects"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.wnids == want.wnids and got.image_names == want.image_names


def test_pth_reads_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    raw = RawCorpus(eeg=rng.normal(size=(4, 3, 10)).astype(np.float32),
                    labels=np.array([0, 1, 0, 1], np.int32), image_idx=np.arange(4, dtype=np.int32),
                    subjects=np.full(4, 2, np.int32), wnids=["n1", "n2"],
                    image_names=[f"n1_{i}" for i in range(4)],
                    means=rng.normal(size=3).astype(np.float32),
                    stddevs=rng.uniform(1, 2, size=3).astype(np.float32))
    save_corpus_pth(str(tmp_path / "t.pth"), raw)
    jax_save_pth(str(tmp_path / "j.pth"), raw)
    for writer in ("t", "j"):
        for load in (load_corpus_pth, jax_load_pth):
            back = load(str(tmp_path / f"{writer}.pth"))
            for field in ("eeg", "labels", "image_idx", "subjects", "means", "stddevs"):
                np.testing.assert_array_equal(getattr(back, field), getattr(raw, field))
            assert back.wnids == raw.wnids and back.image_names == raw.image_names


def test_stimulus_assets_are_the_jax_packages():
    got = ingest.load_stimulus_labels(ingest.IMAGE_RAPID_SEQUENCE)
    assert got == jingest.load_stimulus_labels(jingest.IMAGE_RAPID_SEQUENCE)
    assert len(got[0]) == 2000 and len(got[2]) == 40
    assert (ingest.load_stimulus_labels(ingest.IMAGE_BLOCK_SEQUENCE)
            == jingest.load_stimulus_labels(jingest.IMAGE_BLOCK_SEQUENCE))
    status = np.zeros(100, np.int64)
    status[10:14] = status[50:52] = ingest.STATUS_EVENT
    np.testing.assert_array_equal(ingest.find_status_events(status), [10, 50])


@pytest.mark.parametrize("filtered", ["true", "false"])
def test_convert_to_pth_cli_matches_jax_cli(tmp_path, filtered):
    path, *_ = _recording(tmp_path)
    mfile, sfile = _tables(tmp_path)
    argv = ["--bdf_file", path, "--subject", "4", "--sequence_file", sfile,
            "--image_class_mappings_file", mfile, "--reference_channels", "0,1",
            "--number_of_image_samples", str(N_EVENTS), "--apply_high_low_pass_filter", filtered,
            "--low_pass_cut_freq", "4", "--high_pass_cut_freq", "40"]
    got = convert_main(argv + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    want = jax_convert_main(argv + ["--out_dir", str(tmp_path / "j")])
    name = ("spampinato-4-IMAGE_RAPID_4Hz_40Hz.pth" if filtered == "true"
            else "spampinato-4-IMAGE_RAPID_RAW_with_mean_std.pth")
    back = load_corpus_pth(str(tmp_path / "t" / name))
    jback = jax_load_pth(str(tmp_path / "j" / name))
    assert back.eeg.shape == jback.eeg.shape == (N_EVENTS, 8, 32)  # EXG and Status dropped
    np.testing.assert_allclose(back.eeg, jback.eeg, rtol=0, atol=1e-5 * np.abs(jback.eeg).max())
    np.testing.assert_array_equal(got.labels, want.labels)
    assert list(back.subjects) == [4] * N_EVENTS


def test_convert_to_pth_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_main(["--bdf_file", "missing.bdf"])
