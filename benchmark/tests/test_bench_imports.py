"""Nothing the benchmark runs loads JAX, Flax or the JAX package, and the
reference loads nothing of the program; top-level module names are
compared whole (the program's name begins with the JAX package's)."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, cells

TOPS = "sorted({m.split('.', 1)[0] for m in sys.modules})"
PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT)!r}]
import conftest, harness
"""


def _tops(code):
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("workload", cells())
def test_harness_run_loads_no_jax(root_of, workload):
    tops = _tops(PRELUDE + f"""
cell = conftest.cut(harness.resolve({workload!r},
                                    root={str(root_of(workload))!r}))
harness.run_cell(cell, 9, 0.01, False, device="cpu")
print(json.dumps({TOPS}))
""")
    assert "webrender_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "webrender_tpu"}


@pytest.mark.parametrize("workload", cells())
def test_reference_loads_no_program(root_of, workload):
    tops = _tops(PRELUDE + f"""
import reference, traffic
cell = conftest.cut(harness.resolve({workload!r},
                                    root={str(root_of(workload))!r}))
t = traffic.Traffic(cell.config, cell.mix, 9, cell.home)
t.step()
reference.compose(t.state, reference.identity, cell.home)
reference.compose(t.state, reference.control_quantize, cell.home)
print(json.dumps({TOPS}))
""")
    assert not tops & {"jax", "jaxlib", "flax", "webrender_tpu",
                       "webrender_tpu_torch", "torch"}
