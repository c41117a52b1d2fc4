"""What the harness and the reference load: never ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` (top-level names compared whole),
and the reference nothing of the port either."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(body: str, home) -> set:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(home), "TMPDIR": str(home)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_of_the_harness_loads_no_jax(tmp_path):
    body = ("import tempfile\n"
            "from servebench import tiny, run\n"
            "res = tiny.run(tempfile.mkdtemp(), seconds=0.5)\n"
            "assert res['correct'], res\n"
            "assert run.forbidden_modules() == []\n")
    names = _top_levels(body, tmp_path)
    assert "repro_torch" in names and "servebench" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    names = _top_levels("import servebench.reference.decoder\n"
                        "import servebench.judge, servebench.counts, servebench.traffic\n", tmp_path)
    assert not names & (set(FORBIDDEN) | {"repro_torch"}), names


def test_forbidden_names_are_compared_whole():
    from servebench import run
    assert set(run.FORBIDDEN) == set(FORBIDDEN)
    assert run.forbidden_modules(["repro_torch.models", "servebench.run", "reprox"]) == []
    assert run.forbidden_modules(["repro.models.moe", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
