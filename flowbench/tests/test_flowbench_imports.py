"""Nothing the benchmark loads is JAX, jaxlib, flax or the JAX package, by whole top-level names."""
import subprocess
import sys
from pathlib import Path

from flowbench.lib.bench import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_whole_top_level_names_are_compared():
    assert forbidden_modules(["optical_flow_tpu_torch", "optical_flow_tpu_torch.ops.cuda", "jaxtyping"]) == []
    assert forbidden_modules(["optical_flow_tpu.ops.pallas", "jax._src", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "optical_flow_tpu"]


def test_harness_port_and_reference_load_none_of_them():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import flowbench.lib.bench, flowbench.lib.check, flowbench.reference.flow, flowbench.limits\n"
        "from flowbench.lib import manifest, port\n"
        "import optical_flow_tpu_torch, optical_flow_tpu_torch.parallel.batch\n"
        "m = manifest.load_manifest()\n"
        "for w in m['workloads']:\n"
        "    spec = manifest.resolve_cell(m, w['name'])\n"
        "    for x in spec['end_to_end'] + spec['per_layer']: manifest.reader(x['name'])\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "optical_flow_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optical_flow_tpu"}


def test_sources_name_neither_jax_nor_the_jax_package_nor_its_benchmarks():
    for path in (ROOT / "flowbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        for line in path.read_text().splitlines():
            code = line.split("#")[0]
            assert "import jax" not in code and "from jax" not in code, (path, line)
            assert "optical_flow_tpu." not in code and "optical_flow_tpu " not in code, (path, line)
            assert "benchmarks/" not in code and "import benchmarks" not in code, (path, line)


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "flowbench" / "run.py"), "--workload", "classicpp_mbo_b8",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
