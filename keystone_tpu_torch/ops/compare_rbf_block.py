"""Time this tree's RBF kernel against another tree's on the same card,
on the same arrays, in one process.

Run from the repository root on a machine with the card, with the other
tree unpacked under a git-ignored directory (``git archive <commit> |
tar -x -C _archive/<name>``):

    python3 -m keystone_tpu_torch.ops.compare_rbf_block _archive/<name>

The other tree's ``keystone_tpu_torch`` is loaded under another module
name and builds its own kernel into its own ``_build/``. Both wrappers
run on X (50,000×2048) and Yb, 2048 of X's rows, at gamma 2e-3 (a fit
block of RandomPatchCifarKernel, ``chip_smoke.RBF_GEOMETRIES[0]``), each
checked against this tree's plain version, then timed with
``chip_smoke.device_ms`` in the order baseline, this, this, baseline.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch


def load_tree(root: Path, alias: str):
    """``keystone_tpu_torch.ops.kernels`` of the tree at ``root``,
    imported as ``<alias>.ops.kernels``."""
    pkg = root / "keystone_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.kernels")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("baseline", type=Path,
                        help="root of the other tree")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_rbf_block: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from keystone_tpu_torch.device import resolve_device
    from keystone_tpu_torch.ops import kernels

    dev = resolve_device("cuda")
    base = load_tree(args.baseline.resolve(), "baseline_keystone_tpu_torch")
    m, n, d, gamma = chip_smoke.RBF_GEOMETRIES[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((m, d), generator=gen, device=dev)
    ids = torch.randperm(m, generator=gen, device=dev)[:n]
    Yb = X[ids].contiguous()
    want = kernels.rbf_block_reference(X, Yb, gamma)
    runs = {"baseline": base.rbf_block, "this": kernels.rbf_block}
    result = dict(m=m, n=n, d=d, gamma=gamma, baseline=str(args.baseline))
    for label, fn in runs.items():
        got = fn(X, Yb, gamma)
        torch.cuda.synchronize()
        result[f"{label}_max_abs_err"] = float((got - want).abs().max())
        result[f"{label}_min_diagonal"] = float(
            got[ids, torch.arange(n, device=dev)].min())
        del got
    del want
    order = ("baseline", "this", "this", "baseline")
    times = [chip_smoke.device_ms([lambda f=runs[label]: f(X, Yb, gamma)] * 10)
             for label in order]
    result["order"] = list(order)
    result["order_device_ms"] = times
    result["baseline_device_ms"] = (times[0] + times[3]) / 2
    result["this_device_ms"] = (times[1] + times[2]) / 2
    result["bound_ms"], result["bound_by"] = chip_smoke.k5_bound_ms(m, n, d)
    result["card"] = chip_smoke.card_line()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
