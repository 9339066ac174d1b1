"""What the benchmark loads: nothing of JAX or the JAX package in a cell's
run, and nothing of the program in the reference. Top-level module names
(the part before the first dot) are compared whole: the program's name,
``my_depthsplat_torch``, begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT, SERVE, TRAIN

JAX_NAMES = ("jax", "jaxlib", "flax", "my_depthsplat_tpu")


def _run(code: str) -> list[str]:
    """Run ``code`` in a fresh interpreter from the checkout's root; it
    prints a JSON list of module names last."""
    done = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"},
    )
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_cell_loads_no_jax(workload):
    """A whole (narrow, CPU) run of the cell, traced, then the process's
    modules: none is JAX's, its libraries' or the JAX package's."""
    loaded = _run(f"""
        import json, sys, time, torch
        sys.path.insert(0, "portbench/tests")
        torch.set_num_threads(2)
        from conftest import bench, narrow_cell
        from portbench.run import run_cell
        line, _ = run_cell(bench(), {workload!r}, 7, 0.2, True, "cpu", time.perf_counter(),
                           say=lambda s: None, cell=narrow_cell({workload!r}))
        assert "checks" in line
        print(json.dumps(sorted(sys.modules)))
    """)
    found = [m for m in loaded if m.split(".")[0] in JAX_NAMES]
    assert not found, found
    assert "my_depthsplat_torch" in {m.split(".")[0] for m in loaded}  # the program did run


def test_reference_loads_nothing_of_the_program():
    """Every module of portbench/reference imported in a fresh process
    brings in no module of the program or of JAX."""
    names = sorted(
        "portbench." + ".".join(p.relative_to(ROOT / "portbench").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "portbench" / "reference").rglob("*.py")
    )
    loaded = _run(f"""
        import importlib, json, sys
        for name in {names!r}:
            importlib.import_module(name)
        print(json.dumps(sorted(sys.modules)))
    """)
    found = [m for m in loaded if m.split(".")[0] in ("my_depthsplat_torch", *JAX_NAMES)]
    assert not found, found


def test_reference_sources_import_nothing_of_the_program():
    """No import statement under portbench/reference names the program or
    JAX, absolutely or through a relative path out of the reference."""
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        depth = len(path.relative_to(ROOT / "portbench" / "reference").parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level <= depth + 1, f"{path}: a relative import leaves the reference"
                tops = [node.module.split(".")[0]] if node.level == 0 and node.module else []
            else:
                continue
            bad = [t for t in tops if t in ("my_depthsplat_torch", *JAX_NAMES)]
            assert not bad, f"{path}: imports {bad}"
