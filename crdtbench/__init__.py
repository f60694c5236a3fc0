"""The benchmark of the PyTorch port (``repro_torch``): cells, traffic,
metric readers, the plain reference and the comparison that decides
``correct``. Run a cell with ``python3 crdtbench/run.py``."""

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def find(folder: str, name: str):
    """The module ``crdtbench/<folder>/<name>.py``, loaded once. Mix kinds
    (``kinds/``), topologies (``topologies/``) and metric readers
    (``end_to_end/``, ``layer_metrics/``) are found by the name a cell,
    a configuration or a mix gives, so a later one is a file of its own."""
    key = "crdtbench_{}_{}".format(folder, name).replace(".", "_") \
        .replace("-", "_")
    if key not in sys.modules:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder} file named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]
