"""What a run imports holds no module of JAX, flax or the JAX package, the
reference pulls in nothing of the program, and the look for such modules
compares whole top-level names."""

import subprocess
import sys

from l3bench import context, run

FORBIDDEN = set(context.FORBIDDEN)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=run.ROOT, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_a_run_imports_no_jax():
    top = _loaded("import sys; sys.path.insert(0, '.')\n"
                  "import l3bench.run, l3bench.rank, l3bench.calibrate, l3bench.drivers.extract, l3bench.drivers.train\n"
                  "import l3bench.reference.model, l3bench.traces, l3bench.readers\n"
                  "import l3embedding_torch.embed.extract, l3embedding_torch.embed.quantized\n"
                  "import l3embedding_torch.training.steps, l3embedding_torch.training.loop\n"
                  "import l3embedding_torch.training.state, l3embedding_torch.compat.to_jax\n"
                  "import l3embedding_torch.parallel, l3embedding_torch.models.registry\n"
                  "from pathlib import Path\n"
                  "for f in sorted(Path('l3bench/metrics').glob('*.py')): l3bench.run.reader(f.stem)")
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "l3embedding_torch" in top and "torch" in top


def test_the_reference_imports_nothing_of_the_program():
    top = _loaded("import sys; sys.path.insert(0, '.')\n"
                  "import l3bench.reference.model, l3bench.reference.dsp\n"
                  "import l3bench.check, l3bench.counts, l3bench.weights, l3bench.generate")
    assert not top & (FORBIDDEN | {"l3embedding_torch"}), top


def test_the_look_compares_whole_top_level_names():
    names = ("l3embedding_torch_probe", "jaxtyping_probe", "flaxen_probe")  # names that start like forbidden ones
    for name in names:
        sys.modules.setdefault(name, sys)
    sys.modules.setdefault("jax.numpy_probe", sys)
    try:
        found = context.loaded_forbidden()
        assert not set(names) & set(found)
        assert "jax.numpy_probe" in found
    finally:
        for name in names + ("jax.numpy_probe",):
            del sys.modules[name]
