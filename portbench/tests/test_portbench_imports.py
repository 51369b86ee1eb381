"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import subprocess
import sys

import pytest

from portbench.cells import ROOT
from portbench.run import forbidden_modules


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["cudasbmp_tpu", "cudasbmp_tpu.planners.kgmt"], ["cudasbmp_tpu"]),
    (["cudasbmp_torch", "cudasbmp_torch.parallel", "jaxtyping", "jax_extra",
      "cudasbmp_tpu_torch", "numpy"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert forbidden_modules(names) == found


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return {line.split(".")[0] for line in out.split()}


def test_the_harness_and_the_port_load_no_jax():
    top = _modules_after(
        "import portbench.run, portbench.readings, portbench.sets, portbench.generator\n"
        "import cudasbmp_torch.parallel, cudasbmp_torch.ops.rollout_cuda\n"
        "from portbench import cells\n"
        "for k in ('metrics', 'end_to_end', 'entries', 'judges'):\n"
        "    for f in (cells.HERE / k).glob('*.py'):\n"
        "        cells.reader(k, f.stem)")
    assert "cudasbmp_torch" in top
    assert not forbidden_modules(top)


def test_the_reference_loads_nothing_of_the_program():
    top = _modules_after("import portbench.reference.paths, portbench.reference.bicycle")
    assert "cudasbmp_torch" not in top and not forbidden_modules(top)


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "demo.single", "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True)


def test_a_run_without_the_program_or_a_card_fails_and_prints_nothing(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bare = _run(tmp_path)
    assert bare.returncode != 0 and bare.stdout == ""
    assert "cudasbmp_torch" in bare.stderr
    here = _run(ROOT)  # the CPU: no card
    assert here.returncode != 0 and here.stdout == ""
