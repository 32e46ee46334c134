"""`cerebra_torch.cli.launch` and the ported training CLIs over two gloo ranks
on the CPU: the ranks of every CLI log one loss stream; only rank 0 writes
files; the first failing rank ends the survivors; `--devices 2` outside a
launched world runs two ranks itself; a `--devices` the world cannot take
is refused."""

import os
import re
import subprocess
import sys
import time

import pytest

from cerebra_torch.cli import lstm_distill_from_dinov2_train as cli
from cerebra_torch.cli.launch import _free_port
from tests import _torch_dist as tdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--synthetic", "--device", "cpu", "--use_bf16", "false", "--num_epochs", "2",
         "--synthetic_classes", "4", "--synthetic_per_class", "4", "--synthetic_channels", "6",
         "--synthetic_samples", "48", "--time_low", "4", "--time_high", "36",
         "--feature_dim", "8", "--batch_size", "8"]
CLIS = {
    "lstm_distill_from_dinov2_train": TRAIN,
    "main_dino": ["--synthetic", "--device", "cpu", "--use_bf16", "false", "--arch", "vit_tiny",
                  "--patch_size", "16", "--global_size", "32", "--local_size", "16",
                  "--out_dim", "32", "--epochs", "2", "--synthetic_classes", "4",
                  "--synthetic_per_class", "2", "--batch_size_per_gpu", "2"],
    "barlow_train": ["--synthetic", "--device", "cpu", "--synthetic_classes", "2",
                     "--synthetic_per_class", "4", "--epochs", "2", "--batch_size", "4",
                     "--projector", "32-32", "--n_mels", "32", "--image_size", "32"],
    "conformer_train": ["--synthetic", "--device", "cpu", "--subjects", "1", "--n_epochs", "2",
                        "--batch_size", "16", "--depth", "1", "--emb_size", "20",
                        "--out_features", "16", "--synthetic_per_class", "12",
                        "--synthetic_channels", "6", "--synthetic_samples", "200",
                        "--use_bf16", "false"],
}
LOSS = re.compile(r"^\[rank(\d)\] (EPOCH \d+ .*|Epoch: \d+ .*)$")


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")


def _loss_streams(stdout: str) -> dict:
    streams = {}
    for line in stdout.splitlines():
        m = LOSS.match(line.strip())
        if m:
            streams.setdefault(m.group(1), []).append(re.sub(r"\(.* windows/s\)", "", m.group(2)))
    return streams


@pytest.mark.parametrize("name", sorted(CLIS))
def test_two_ranks_of_each_trainer_log_one_loss_stream(name, tmp_path):
    """`--devices 2 --device cpu` outside a launched world: the CLI runs
    itself as two ranks through launch; both print the same losses (the
    windows/s each measured aside) and exit 0."""
    out = subprocess.run(
        [sys.executable, "-m", f"cerebra_torch.cli.{name}", *CLIS[name], "--devices", "2",
         "--log_dir", str(tmp_path)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    streams = _loss_streams(out.stdout)
    assert sorted(streams) == ["0", "1"], out.stdout[-2000:]
    assert len(streams["0"]) == 2 and streams["0"] == streams["1"], streams


def _cli_rank(argv_base, log_root):
    import torch.distributed as dist

    rank = dist.get_rank()
    model, hist = cli.main(argv_base + ["--log_dir", os.path.join(log_root, f"rank{rank}")])
    return hist["train_loss"]


def test_only_rank_zero_writes_files(tmp_path):
    """Each rank of a spawned world is given its own --log_dir: rank 0's
    holds log.txt and the best-loss .pth, rank 1's stays empty."""
    argv = TRAIN[:] + ["--num_epochs", "6"]
    losses = tdist.run_world(_cli_rank, 2, argv, str(tmp_path))
    assert losses[0] == losses[1] and len(losses[0]) == 6
    assert sorted(os.listdir(tmp_path / "rank0")) == ["log.txt", "lstm_dinov2_best_loss.pth"]
    assert os.listdir(tmp_path / "rank1") == []
    assert len((tmp_path / "rank0" / "log.txt").read_text().splitlines()) == 6


def test_launch_sets_the_env_and_prefixes_each_rank(tmp_path):
    code = ("import os; print(os.environ['RANK'], os.environ['LOCAL_RANK'], "
            "os.environ['WORLD_SIZE'], os.environ['MASTER_ADDR'], os.environ['MASTER_PORT'])")
    port = _free_port()
    out = subprocess.run(
        [sys.executable, "-m", "cerebra_torch.cli.launch", "--nproc", "3", "--coordinator",
         f"127.0.0.1:{port}", "--", sys.executable, "-c", code],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    lines = sorted(out.stdout.splitlines())
    assert lines == [f"[rank{r}] {r} {r} 3 127.0.0.1 {port}" for r in range(3)], lines


def test_the_first_failing_rank_terminates_the_survivors():
    """Rank 1 exits 3 at once; rank 0 would sleep for a minute and is
    terminated: launch returns 3 well before."""
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(60)")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "cerebra_torch.cli.launch", "--nproc", "2", "--", sys.executable,
         "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, (out.returncode, out.stderr)
    assert time.monotonic() - t0 < 30
    assert "rank 1 exited with 3" in out.stderr


def test_devices_inside_a_world_must_be_zero_or_its_size(monkeypatch, tmp_path):
    """Inside a launched world of 2, --devices 3 is refused before any
    process group is brought up; --devices 1 too."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    for n in ("3", "1"):
        with pytest.raises(SystemExit, match=f"--devices {n} inside a launched world of 2"):
            cli.main(TRAIN + ["--devices", n, "--log_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "log.txt")


def test_devices_two_in_process_runs_two_ranks_and_returns(tmp_path, capfd):
    """`main([... --devices 2])` called in a process that is no rank: the
    two ranks train and write, and main returns None."""
    assert cli.main(TRAIN + ["--devices", "2", "--log_dir", str(tmp_path)]) is None
    out = capfd.readouterr().out
    streams = _loss_streams(out)
    assert streams["0"] == streams["1"] and len(streams["0"]) == 2, out[-2000:]
    assert len((tmp_path / "log.txt").read_text().splitlines()) == 2
