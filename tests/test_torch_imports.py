"""Import hygiene of the port: it imports neither JAX nor the JAX package
(nor scikit-learn, which its estimators do without), and importing it
builds no kernel."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the package's sources; _build/ holds what is built or unpacked at run time
PORT_FILES = sorted(p for p in (ROOT / "lightgbm_torch").rglob("*.py")
                    if "_build" not in p.relative_to(ROOT).parts) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import json, sys\n"
        "import lightgbm_torch\n"
        "from lightgbm_torch import ranking, sklearn\n"
        "from lightgbm_torch.kernels import build\n"
        "print(json.dumps({'mods': sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'lightgbm_tpu', 'sklearn')),\n"
        "    'loaded': sorted(build._LOADED),\n"
        "    'counts': lightgbm_torch.kernels.launch_counts()}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"mods": [], "loaded": [],
                   "counts": {"predict_stream": 0, "route_and_hist": 0,
                              "route_and_hist_int": 0,
                              "route_replay": 0, "leaf_gather": 0,
                              "scatter_hist": 0, "hist_direct": 0,
                              "hist_nibble": 0, "hist_wide": 0,
                              "bin_rows": 0, "predict_leaf": 0,
                              "tree_shap": 0, "bin_csr": 0}}
