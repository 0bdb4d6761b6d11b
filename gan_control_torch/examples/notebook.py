"""Run a notebook's code cells in order, in one namespace, without Jupyter
(the card's machine has none).

    python -m gan_control_torch.examples.notebook [PATH]

PATH defaults to ``gan_control_inference_example.ipynb`` beside this
module, which reads ``GANCTL_CONTROLLER_DIR``, ``GANCTL_OUT`` and
``GANCTL_DEVICE`` from the environment. A cell that raises stops the run
with its index.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

EXAMPLE = Path(__file__).resolve().parent / "gan_control_inference_example.ipynb"


def code_cells(path: str | Path = EXAMPLE) -> list[str]:
    """The source of each code cell, in order."""
    nb = json.loads(Path(path).read_text())
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def run(path: str | Path = EXAMPLE) -> dict:
    """Executes every code cell in order in one fresh namespace; returns
    it."""
    namespace: dict = {"__name__": "__notebook__"}
    for i, source in enumerate(code_cells(path)):
        try:
            exec(compile(source, f"{Path(path).name}[cell {i}]", "exec"), namespace)
        except Exception as e:
            raise RuntimeError(f"{path}: code cell {i} failed") from e
    return namespace


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else EXAMPLE)
