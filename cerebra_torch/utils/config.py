"""Flag and process helpers (port of cerebra/utils/config.py).

`--hyperprams` is parsed without eval(): JSON first, then a Python-literal
fallback (ast.literal_eval) so the reference's single-quoted strings work.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
from typing import Dict


def bool_flag(s: str) -> bool:
    falsy = {"off", "false", "0"}
    truthy = {"on", "true", "1"}
    if s.lower() in falsy:
        return False
    if s.lower() in truthy:
        return True
    raise argparse.ArgumentTypeError("invalid value for a boolean flag")


def parse_hyperparams(s: str) -> Dict:
    """Parse `--hyperprams "{'alpha': 1, ...}"` without eval()."""
    if not s:
        return {}
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        try:
            out = ast.literal_eval(s)
        except (ValueError, SyntaxError) as e:
            raise SystemExit(
                f"--hyperprams is neither JSON nor a Python literal dict: {s!r} ({e})"
            )
        if not isinstance(out, dict):
            raise SystemExit(f"--hyperprams must be a dict, got {type(out).__name__}")
        return out


def fix_random_seeds(seed: int = 31) -> None:
    """Seed numpy and torch (every device) like utils/utils.py:215-221."""
    import numpy as np
    import torch

    np.random.seed(seed)
    torch.manual_seed(seed)


def get_sha() -> str:
    """Current git SHA + dirty flag (utils/utils.py:403-420)."""
    cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=cwd, stderr=subprocess.DEVNULL
        ).decode().strip()
        diff = subprocess.check_output(
            ["git", "diff-index", "HEAD"], cwd=cwd, stderr=subprocess.DEVNULL
        ).decode().strip()
        return f"sha: {sha}, status: {'has uncommitted changes' if diff else 'clean'}"
    except (OSError, subprocess.CalledProcessError):  # no git, or not a checkout
        return "sha: N/A"


def is_main_process() -> bool:
    """Rank-0 check (utils/utils.py:436-449): True unless a torch.distributed
    process group is up and this process is not rank 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """Gate print() to the master process (utils/utils.py:452-464); `force=True`
    prints anywhere."""
    import builtins

    builtin_print = builtins.print

    def gated(*args, force=False, **kwargs):
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = gated
