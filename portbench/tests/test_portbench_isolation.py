"""What each part of the benchmark may import: the reference nothing of
the program; a cell's whole import path no module whose top-level name is
exactly `jax`, `jaxlib`, `flax` or `garment4d_tpu` (the port's name begins
with the JAX package's, so names are compared whole)."""

import subprocess
import sys

from portbench import harness

CHECK = ("import sys\n"
         "tops = set(m.split('.')[0] for m in sys.modules)\n"
         "print(sorted(tops & NAMES))\n")


def loaded(code, names):
    out = subprocess.run([sys.executable, "-c", f"NAMES = {names}\n" + code + CHECK],
                         cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_reference_imports_nothing_of_the_program():
    code = ("import portbench.reference.network, portbench.reference.train, "
            "portbench.reference.geometry, portbench.compare, portbench.inputs\n")
    assert loaded(code, "{'garment4d_tpu_torch', 'garment4d_tpu', 'jax', 'jaxlib', "
                        "'flax'}") == "[]"


def test_a_cells_import_path_loads_no_jax():
    code = ("import portbench.run, portbench.harness, portbench.calibrate\n"
            "import portbench.paths.reconstruct, portbench.paths.train_posed, "
            "portbench.paths.train_canonical\n"
            "from portbench import harness, program\n"
            "c = harness.load_cell('skirt-reconstruct')\n"
            "program.assets(c.template, 'Skirt')\n"
            "import garment4d_tpu_torch.api, garment4d_tpu_torch.train\n"
            "import garment4d_tpu_torch.models\n")
    assert loaded(code, "{'jax', 'jaxlib', 'flax', 'garment4d_tpu'}") == "[]"


def test_forbidden_names_are_compared_whole():
    assert "garment4d_tpu_torch" not in harness.FORBIDDEN
    before = set(sys.modules)
    try:
        sys.modules["garment4d_tpu_torch_x"] = sys
        sys.modules["jaxtools.sub"] = sys
        assert harness.forbidden_modules() == sorted(
            {m.split(".")[0] for m in before} & set(harness.FORBIDDEN))
        sys.modules["jax.numpy"] = sys
        assert "jax" in harness.forbidden_modules()
    finally:
        for m in ("garment4d_tpu_torch_x", "jaxtools.sub", "jax.numpy"):
            if m not in before:
                sys.modules.pop(m, None)
