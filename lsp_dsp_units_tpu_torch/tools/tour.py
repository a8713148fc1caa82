"""Run the port's API tour (``docs/API_TOUR.md`` in this package): every
``python`` block in document order, in one namespace, on one device.

    python3 -m lsp_dsp_units_tpu_torch.tools.tour [--cpu]

The tour's first block binds ``device = torch.device("cuda")``.
:func:`run` replaces that line with the device it is given: the one
mechanism by which the CPU test (``tests/test_torch_docs.py``) and
``chip_smoke.py``'s tour phase (the card) choose where the tour runs.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from typing import List

import torch

TOUR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs", "API_TOUR.md")
BINDING = 'device = torch.device("cuda")'


def blocks() -> List[str]:
    """The tour's ``python`` blocks, in document order."""
    with open(TOUR) as f:
        return re.findall(r"```python\n(.*?)```", f.read(), re.DOTALL)


def run(device) -> dict:
    """Every block on ``device``, in one namespace; returns the namespace.
    A failing block raises, naming itself."""
    code = blocks()
    if BINDING not in code[0]:
        raise ValueError(f"the tour's first block does not bind {BINDING}")
    code[0] = code[0].replace(
        BINDING, f"device = torch.device({str(torch.device(device))!r})")
    ns: dict = {}
    for i, block in enumerate(code):
        try:
            exec(compile(block, f"API_TOUR.md[block {i}]", "exec"), ns)
        except Exception as e:
            raise RuntimeError(f"tour block {i} failed: {e!r}\n---\n"
                               f"{block}") from e
    return ns


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    run("cpu" if args.cpu else "cuda")
    print(f"{len(blocks())} blocks ran in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
