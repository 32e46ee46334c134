"""Flag helpers (copy of cerebra/utils/config.py: bool_flag,
parse_hyperparams, is_main_process).

`--hyperprams` is parsed without eval(): JSON first, then a Python-literal
fallback (ast.literal_eval) so the reference's single-quoted strings work.
"""

from __future__ import annotations

import argparse
import ast
import json
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


def is_main_process() -> bool:
    """Rank-0 check (utils/utils.py:436-449): True unless a torch.distributed
    process group is up and this process is not rank 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
