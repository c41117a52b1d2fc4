"""repro_torch.analysis, the port's twin of repro.analysis, held finding
for finding to the reference: the reference's own cases through both
analyzers, each real tree through both, the torch spellings the twin adds
to determinism and jit-hygiene, the port's tree against its baseline, and
the CLI.

Findings are compared as ``(pass_id, path, line, col, slug, message)``
under one name map: the twin reads ``TORCH_POLICIES`` / ``TorchPolicy``
where the reference reads ``JAX_POLICIES`` / ``JaxPolicy``, its
registry-parity slug for an in-tick policy without a vector twin starts
``torch-`` where the reference's starts ``jax-``, and its GitHub
annotations are titled ``repro_torch.analysis``.

Every fixture lives in a string written under ``tmp_path``: the
reference's analyzer scans ``tests/`` for policy parametrizations.
"""
import ast
import hashlib
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref
import repro_torch.analysis as twin
from repro.analysis.passes import jit_hygiene as ref_jit
from repro_torch.analysis.passes import jit_hygiene as twin_jit

REPO = Path(__file__).resolve().parents[1]

ALL_PASSES = ("registry-parity", "jit-hygiene", "determinism",
              "telemetry-guard", "soa-aliasing")

#: reference spelling -> twin spelling, in source text and in messages
NAME_MAP = (("JAX_POLICIES", "TORCH_POLICIES"), ("JaxPolicy", "TorchPolicy"))
#: registry-parity slug prefix of an in-tick policy without a vector twin
SLUG_PREFIX = ("jax-", "torch-")

PORT_BASELINED = ["torch-rl_sample-missing-vector-twin",
                  "vector-rl_pool-missing-dict-twin"]
#: sha256 of the reference's analysis_baseline.txt, which the port leaves
#: as it is
REF_BASELINE_SHA256 = (
    "bbc2bd9691a4092dcc5211882a7e0a17b157e52c5c861253f58c91f7824b2185")


def to_twin(text):
    for a, b in NAME_MAP:
        text = text.replace(a, b)
    return text


def to_ref(text):
    for a, b in NAME_MAP:
        text = text.replace(b, a)
    return text


def rows(findings, from_twin=False):
    """Comparable rows; the twin's are mapped to the reference's names."""
    out = []
    for f in findings:
        slug, message = f.slug, f.message
        if from_twin:
            message = to_ref(message)
            if f.pass_id == "registry-parity" and slug.startswith(SLUG_PREFIX[1]):
                slug = SLUG_PREFIX[0] + slug[len(SLUG_PREFIX[1]):]
        out.append((f.pass_id, f.path, f.line, f.col, slug, message))
    return out


def _write(root, files):
    for rel, source in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(source))


def _analyze(pkg, root, select=None):
    ctx = pkg.AnalysisContext([str(root / "src")], repo_root=str(root))
    return pkg.run_passes(ctx, select=[select] if select else None)


def _both(tmp_path, files, select=None):
    """Analyze ``files`` with the reference and their mapped text with the
    twin (the tree is written once where the map changes nothing); the
    findings must agree under the map.  Returns (reference, twin)."""
    ref_root = tmp_path / "tree"
    _write(ref_root, files)
    mapped = {rel: to_twin(src) for rel, src in files.items()}
    twin_root = ref_root
    if mapped != files:
        twin_root = tmp_path / "tree_twin"
        _write(twin_root, mapped)
    r = _analyze(ref, ref_root, select)
    t = _analyze(twin, twin_root, select)
    assert rows(t, from_twin=True) == rows(r)
    return r, t


def _run(tmp_path, files, select):
    return _both(tmp_path, files, select)[0]


def _slugs(findings):
    return {f.slug for f in findings}


def _cli(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True)


# ---------------------------------------------------------------------------
# 1. the cases of tests/test_analysis.py, each through both analyzers; a
#    case is registered under the reference test's name
# ---------------------------------------------------------------------------
CASES = {}


def case(fn):
    CASES["test_" + fn.__name__] = fn
    return fn


@case
def pass_registry_is_complete(tmp_path):
    for pkg in (ref, twin):
        assert tuple(pkg.PASS_REGISTRY) == ALL_PASSES
        for lp in pkg.PASS_REGISTRY.values():
            assert lp.description
    assert "TORCH_POLICIES" in twin.PASS_REGISTRY["registry-parity"].description


@case
def registry_parity_flags_missing_twins(tmp_path):
    findings, twin_findings = _both(tmp_path, {
        "src/regs.py": """
            SCHEDULERS = {"reactive": 1}
            VECTOR_SCHEDULERS = {"reactive": 2}
            VECTOR_SCHEDULERS["soa_only"] = 3
            JAX_POLICIES = {"reactive": 4, "scan_only": 5}
        """,
    }, "registry-parity")
    assert _slugs(findings) == {
        "vector-soa_only-missing-dict-twin",
        "jax-scan_only-missing-vector-twin",
    }
    assert _slugs(twin_findings) == {
        "vector-soa_only-missing-dict-twin",
        "torch-scan_only-missing-vector-twin",
    }
    assert all(f.key.startswith("registry-parity:")
               for f in findings + twin_findings)


@case
def registry_parity_flags_stale_test_parametrization(tmp_path):
    findings = _run(tmp_path, {
        "src/regs.py": 'SCHEDULERS = {"reactive": 1}\n',
        "tests/test_parity.py": """
            import pytest

            @pytest.mark.parametrize("policy", ["reactive", "ghost"])
            def test_p(policy):
                pass
        """,
    }, "registry-parity")
    assert _slugs(findings) == {"test-param-ghost-unregistered"}


@case
def registry_parity_silent_on_twinned_registries(tmp_path):
    findings = _run(tmp_path, {
        "src/regs.py": """
            SCHEDULERS = {"reactive": 1, "paragon": 2}
            VECTOR_SCHEDULERS = {"reactive": 3, "paragon": 4}
            JAX_POLICIES = {"reactive": 5}
        """,
        "tests/test_parity.py": """
            import pytest

            @pytest.mark.parametrize("policy", ["reactive", "paragon"])
            def test_p(policy):
                pass

            @pytest.mark.parametrize("policy", sorted({"computed"}))
            def test_computed(policy):   # non-literal lists are skipped
                pass
        """,
    }, "registry-parity")
    assert findings == []


@case
def jit_hygiene_flags_host_syncs_and_branches(tmp_path):
    findings = _run(tmp_path, {
        "src/hot.py": """
            import jax
            import jax.numpy as jnp
            import numpy as np

            @jax.jit
            def step(x):
                if x > 0:
                    x = np.maximum(x, 0.0)
                y = x.item()
                return float(x) + y
        """,
    }, "jit-hygiene")
    assert _slugs(findings) == {
        "step-python-if-on-traced",
        "step-np-on-traced-maximum",
        "step-host-sync-item",
        "step-host-sync-float",
    }


@case
def jit_hygiene_follows_scan_vmap_and_jaxpolicy_roots(tmp_path):
    findings = _run(tmp_path, {
        "src/engine.py": """
            import jax
            from helpers import shared

            def body(carry, x):
                return shared(carry), x

            def run(xs):
                return jax.lax.scan(body, 0.0, xs)

            JAX_POLICIES = {"p": JaxPolicy(pol)}

            def pol(state):
                return state.q.item()
        """,
        "src/helpers.py": """
            def shared(c):
                while c:
                    c = c - 1
                return c
        """,
    }, "jit-hygiene")
    assert _slugs(findings) == {
        "shared-python-while-on-traced",
        "pol-host-sync-item",
    }


@case
def jit_hygiene_flags_unhashable_static_arg(tmp_path):
    findings = _run(tmp_path, {
        "src/hot.py": """
            from functools import partial
            import jax

            @partial(jax.jit, static_argnames=("cfg",))
            def update(x, cfg):
                return x

            update(1.0, cfg={"lr": 0.1})
        """,
    }, "jit-hygiene")
    assert _slugs(findings) == {"unhashable-static-update-cfg"}


@case
def jit_hygiene_silent_on_compliant_jit_code(tmp_path):
    findings = _run(tmp_path, {
        "src/hot.py": """
            from functools import partial
            import jax
            import jax.numpy as jnp
            import numpy as np

            @partial(jax.jit, static_argnames=("mode",))
            def step(x, key, mode, lazy: bool, xp=np, unroll=4):
                if mode == "fast":
                    x = jnp.maximum(x, 0.0)
                if lazy:
                    x = x * 2
                if xp is np:
                    pass
                if x.shape[0] > unroll:
                    x = x[:unroll]
                return jnp.where(x > 0, x, 0.0)
        """,
    }, "jit-hygiene")
    assert findings == []


@case
def jit_hygiene_ignores_host_side_code(tmp_path):
    findings = _run(tmp_path, {
        "src/host.py": """
            import numpy as np

            def summarize(xs):
                if xs.size:
                    return float(np.mean(xs))
                return 0.0
        """,
    }, "jit-hygiene")
    assert findings == []


@case
def determinism_flags_global_state_randomness(tmp_path):
    findings = _run(tmp_path, {
        "src/bad.py": """
            import random
            import time
            import numpy as np

            def draw(n):
                seed = time.time()
                np.random.seed(int(seed))
                return np.random.rand(n) + random.random()
        """,
    }, "determinism")
    assert _slugs(findings) == {
        "draw-np-random-seed",
        "draw-np-random-rand",
        "draw-stdlib-random-random",
        "draw-clock-seed",
    }


@case
def determinism_flags_from_random_import(tmp_path):
    findings = _run(tmp_path, {
        "src/bad.py": "from random import shuffle\n",
    }, "determinism")
    assert _slugs(findings) == {"from-random-import"}


@case
def determinism_silent_on_seeded_generators(tmp_path):
    findings = _run(tmp_path, {
        "src/good.py": """
            import time
            import numpy as np
            import jax

            def draw(n, seed):
                rng = np.random.default_rng(seed)
                key = jax.random.PRNGKey(seed)
                t0 = time.perf_counter()
                out = rng.normal(size=n) + jax.random.uniform(key, (n,))
                return out, time.perf_counter() - t0
        """,
    }, "determinism")
    assert findings == []


_TEL = """
    EV_ARRIVAL = "arrival"
    EVENT_TYPES = {EV_ARRIVAL: "arrivals this tick", "serve": "served"}

    class Telemetry:
        def emit(self, tick, etype, value):
            pass
"""


@case
def telemetry_guard_flags_unguarded_emission(tmp_path):
    findings = _run(tmp_path, {
        "src/tel.py": _TEL,
        "src/engine.py": """
            def step(self, tick):
                tel = self.telemetry
                tel.emit(tick, "arrival", 1)
        """,
    }, "telemetry-guard")
    assert _slugs(findings) == {"unguarded-step-emit"}


@case
def telemetry_guard_flags_unknown_etype_and_ev_const(tmp_path):
    findings = _run(tmp_path, {
        "src/tel.py": _TEL + '\n    EV_GHOST = "ghost"\n',
        "src/engine.py": """
            def step(self, tick):
                tel = self.telemetry
                if tel is not None:
                    tel.emit(tick, "arival", 1)
        """,
    }, "telemetry-guard")
    assert _slugs(findings) == {
        "etype-const-EV_GHOST-undocumented",
        "etype-arival-unknown",
    }


@case
def telemetry_guard_silent_on_guarded_idioms(tmp_path):
    findings = _run(tmp_path, {
        "src/tel.py": _TEL,
        "src/engine.py": """
            def a(self, tick):
                tel = self.telemetry
                if tel is not None:
                    tel.emit(tick, "arrival", 1)

            def b(self, tick):
                if self.telemetry is not None:
                    self.telemetry.emit(tick, "serve", 2)

            def c(self, tick, tel):
                if tel is None:
                    return
                tel.emit(tick, "arrival", 3)

            def d(self, tick, tel, extra):
                if tel is not None and extra:
                    tel.emit(tick, "serve", 4)
        """,
    }, "telemetry-guard")
    assert findings == []


@case
def telemetry_guard_flags_undocumented_summary_key(tmp_path):
    findings = _run(tmp_path, {
        "src/acct.py": """
            SUMMARY_KEY_DOCS = {
                "total_cost": "ledger total",
                "cost_<tier>": "per-tier cost",
            }

            class SimResult:
                def summary(self):
                    s = {
                        "total_cost": 1.0,
                        "mystery": 2.0,
                        **{f"cost_{t}": 0.0 for t in ("od",)},
                    }
                    s["also_undocumented"] = 3.0
                    return s
        """,
    }, "telemetry-guard")
    assert _slugs(findings) == {
        "summary-key-mystery-undocumented",
        "summary-key-also_undocumented-undocumented",
    }


_POOLOBS = """
    class PoolObs:
        rate: object
        backlog: object

        def copy(self):
            return self
"""


@case
def soa_aliasing_flags_uncopied_field_store(tmp_path):
    findings = _run(tmp_path, {
        "src/types.py": _POOLOBS,
        "src/agent.py": """
            class Agent:
                def step(self):
                    obs = self.sim.observe_pool()
                    self._prev_rate = obs.rate
        """,
    }, "soa-aliasing")
    assert _slugs(findings) == {"step-_prev_rate-aliases-rate"}


@case
def soa_aliasing_silent_on_copy_and_locals(tmp_path):
    findings = _run(tmp_path, {
        "src/types.py": _POOLOBS,
        "src/agent.py": """
            class Agent:
                def step(self):
                    obs = self.sim.observe_pool()
                    self._prev_rate = obs.rate.copy()
                    self._pobs = self.sim.observe_pool()
                    rate = obs.rate
                    return rate
        """,
    }, "soa-aliasing")
    assert findings == []


@case
def baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.txt"
    p.write_text("determinism:src/x.py:some-slug\n")
    for pkg in (ref, twin):
        with pytest.raises(pkg.BaselineError):
            pkg.load_baseline(str(p))


@case
def baseline_matches_by_stable_key_and_reports_stale(tmp_path):
    p = tmp_path / "baseline.txt"
    p.write_text(
        "determinism:src/bad.py:draw-np-random-rand  # legacy shim\n"
        "determinism:src/bad.py:gone-finding  # fixed long ago\n")
    findings, twin_findings = _both(tmp_path, {
        "src/bad.py": """
            import numpy as np

            def draw(n):
                return np.random.rand(n)
        """,
    }, "determinism")
    new, baselined, stale = ref.apply_baseline(
        findings, ref.load_baseline(str(p)))
    t_new, t_baselined, t_stale = twin.apply_baseline(
        twin_findings, twin.load_baseline(str(p)))
    assert new == [] and t_new == []
    assert [f.slug for f in baselined] == ["draw-np-random-rand"]
    assert rows(t_baselined, from_twin=True) == rows(baselined)
    assert [e.key for e in stale] == ["determinism:src/bad.py:gone-finding"]
    assert [(e.key, e.justification, e.line) for e in t_stale] == [
        (e.key, e.justification, e.line) for e in stale]


@case
def parse_errors_are_reported_as_findings(tmp_path):
    findings = _run(tmp_path, {"src/broken.py": "def f(:\n"}, None)
    assert [f.slug for f in findings] == ["syntax-error"]


def _clean_against(pkg, root, baseline):
    ctx = pkg.AnalysisContext([str(REPO / root)], repo_root=str(REPO))
    entries = pkg.load_baseline(str(REPO / baseline))
    return pkg.apply_baseline(pkg.run_passes(ctx), entries)


@case
def repo_src_is_clean_against_baseline(tmp_path):
    # each analyzer over its own tree, against its own baseline
    new, baselined, stale = _clean_against(ref, "src", "analysis_baseline.txt")
    t_new, t_baselined, t_stale = _clean_against(
        twin, "src/repro_torch", "analysis_baseline_torch.txt")
    assert new == [] and t_new == [], "\n".join(
        f.format_text() for f in new + t_new)
    assert stale == [] and t_stale == []
    assert sorted(f.slug for f in baselined) == [
        "jax-rl_sample-missing-vector-twin",
        "vector-rl_pool-missing-dict-twin",
    ]
    assert sorted(s for *_, s, _ in rows(t_baselined, from_twin=True)) == \
        sorted(f.slug for f in baselined)


@case
def cli_exits_zero_on_clean_tree(tmp_path):
    for module, path in (("repro.analysis", "src"),
                         ("repro_torch.analysis", "src/repro_torch")):
        r = _cli(module, path)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 finding(s)" in r.stderr
        assert "2 baselined" in r.stderr


@case
def cli_github_format_emits_annotations(tmp_path):
    counts = []
    for module, path in (("repro.analysis", "src"),
                         ("repro_torch.analysis", "src/repro_torch")):
        r = _cli(module, path, "--format", "github", "--baseline", "none",
                 "--select", "registry-parity")
        assert r.returncode == 1
        lines = [ln for ln in r.stdout.splitlines() if ln]
        assert lines, r.stderr
        for ln in lines:
            assert ln.startswith("::error file=")
            assert f"title={module} registry-parity" in ln
        counts.append(len(lines))
    assert counts[0] == counts[1]


@case
def cli_lists_passes(tmp_path):
    for module in ("repro.analysis", "repro_torch.analysis"):
        r = _cli(module, "--list")
        assert r.returncode == 0
        for pid in ALL_PASSES:
            assert pid in r.stdout


@case
def cli_rejects_unknown_pass(tmp_path):
    for module, path in (("repro.analysis", "src"),
                         ("repro_torch.analysis", "src/repro_torch")):
        r = _cli(module, path, "--select", "no-such-pass")
        assert r.returncode == 2
        assert "unknown pass" in r.stderr


def test_every_reference_case_is_mirrored():
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    names = {n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert len(names) == 26
    assert set(CASES) == names


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case_through_both_analyzers(name, tmp_path):
    CASES[name](tmp_path)


# ---------------------------------------------------------------------------
# 2. each real tree through both analyzers, no baseline
# ---------------------------------------------------------------------------
def _copy_tree(dst_root, package, rename):
    """``src/<package>`` with ``rename`` applied to every source, and the
    repo's tests/ beside it, so paths and the cross-check tree match."""
    src = REPO / "src" / package
    for path in sorted(src.rglob("*.py")):
        out = dst_root / "src" / package / path.relative_to(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(rename(path.read_text()))
    shutil.copytree(REPO / "tests", dst_root / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))


def _torch_spelling(row):
    """A finding only the twin's torch rules can raise."""
    pass_id, *_, slug, _message = row
    return ((pass_id == "jit-hygiene"
             and ("host-sync-cpu" in slug or "host-sync-numpy" in slug))
            or (pass_id == "determinism" and "torch-random-" in slug))


def test_reference_tree_gives_equal_findings_through_both(tmp_path):
    # the reference over src/repro; the twin over a copy with the
    # reference's two identifiers renamed to the port's
    _copy_tree(tmp_path, "repro", to_twin)
    r = ref.run_passes(ref.AnalysisContext([str(REPO / "src" / "repro")],
                                           repo_root=str(REPO)))
    t = twin.run_passes(twin.AnalysisContext(
        [str(tmp_path / "src" / "repro")], repo_root=str(tmp_path)))
    print(f"src/repro: reference {len(r)} finding(s), twin {len(t)}")
    assert rows(t, from_twin=True) == rows(r)
    assert sorted(f.slug for f in r) == [
        "jax-rl_sample-missing-vector-twin",
        "vector-rl_pool-missing-dict-twin",
    ]


def test_port_tree_gives_equal_findings_through_both(tmp_path):
    # the twin over src/repro_torch; the reference over a copy with the
    # port's two identifiers renamed back to the reference's
    _copy_tree(tmp_path, "repro_torch", to_ref)
    t = twin.run_passes(twin.AnalysisContext(
        [str(REPO / "src" / "repro_torch")], repo_root=str(REPO)))
    r = ref.run_passes(ref.AnalysisContext(
        [str(tmp_path / "src" / "repro_torch")], repo_root=str(tmp_path)))
    t_rows, r_rows = rows(t, from_twin=True), rows(r)
    extra = [row for row in t_rows if row not in r_rows]
    print(f"src/repro_torch: twin {len(t)} finding(s), reference {len(r)}, "
          f"torch spellings only the twin raises {len(extra)}")
    assert all(_torch_spelling(row) for row in extra), extra
    assert [row for row in t_rows if row not in extra] == r_rows
    assert sorted(f.slug for f in t) == PORT_BASELINED


# ---------------------------------------------------------------------------
# 3. the torch spellings of determinism and jit-hygiene
# ---------------------------------------------------------------------------
def test_determinism_flags_torch_global_generator(tmp_path):
    files = {"src/bad.py": """
        import torch

        def draw(n):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            return torch.rand(3) + torch.randn(3, generator=None)
    """}
    _write(tmp_path, files)
    assert _slugs(_analyze(twin, tmp_path, "determinism")) == {
        "draw-torch-random-manual_seed",
        "draw-torch-random-manual_seed_all",
        "draw-torch-random-rand",
        "draw-torch-random-randn",
    }
    assert _analyze(ref, tmp_path, "determinism") == []   # torch is new


def test_determinism_silent_on_seeded_torch_generators(tmp_path):
    # the first form is a chain through a call (no dotted name); the last
    # has one, torch.Generator.manual_seed, which is not torch's global
    # generator: the rule matches full paths, not their tails
    _write(tmp_path, {"src/good.py": """
        import torch

        def draw(seed, device):
            g = torch.Generator().manual_seed(seed)
            gen = torch.Generator(device)
            gen.manual_seed(1)
            torch.Generator.manual_seed(gen, 2)
            return (torch.rand(3, generator=g)
                    + torch.randn(3, generator=gen, device=device))
    """})
    assert _analyze(twin, tmp_path, "determinism") == []


_TORCH_POLICY_SRC = """
    import torch

    def {name}(params, obs, xs):
        if obs.q > 0:
            obs = obs.q.cpu()
        return obs.numpy().item()
"""


def test_jit_hygiene_flags_syncs_under_a_torch_policy(tmp_path):
    _write(tmp_path, {"src/engine.py": _TORCH_POLICY_SRC.format(name="pol")
                      + """
    TORCH_POLICIES = {"p": TorchPolicy(pol, False, False, dict)}
    """})
    assert _slugs(_analyze(twin, tmp_path, "jit-hygiene")) == {
        "pol-python-if-on-traced",
        "pol-host-sync-cpu",
        "pol-host-sync-numpy",
        "pol-host-sync-item",
    }
    assert _analyze(ref, tmp_path, "jit-hygiene") == []   # no JaxPolicy


def test_jit_hygiene_silent_where_no_root_reaches(tmp_path):
    _write(tmp_path, {"src/engine.py": _TORCH_POLICY_SRC.format(name="host")
                      + """
    TORCH_POLICIES = {"p": TorchPolicy(pol, False, False, dict)}

    def pol(params, obs, xs):
        return obs
    """})
    assert _analyze(twin, tmp_path, "jit-hygiene") == []


def test_jit_hygiene_reaches_the_torch_engine_policy_path():
    ctx = twin.AnalysisContext([str(REPO / "src" / "repro_torch")],
                               repo_root=str(REPO))
    reached = {fn.name for _mod, fn, _ in twin_jit._reachable(ctx).values()}
    assert {"_pol_reactive", "_pol_rl_sample", "sample_categorical",
            "policy_logits_torch", "pool_features_torch",
            "procurement_targets_torch"} <= reached
    ref_ctx = ref.AnalysisContext([str(REPO / "src" / "repro_torch")],
                                  repo_root=str(REPO))
    assert ref_jit._reachable(ref_ctx) == {}


# ---------------------------------------------------------------------------
# 4. the port's tree against its own baseline
# ---------------------------------------------------------------------------
def test_port_tree_is_clean_against_its_baseline():
    new, baselined, stale = _clean_against(
        twin, "src/repro_torch", "analysis_baseline_torch.txt")
    assert new == [], "\n".join(f.format_text() for f in new)
    assert stale == [], [e.key for e in stale]
    assert sorted(f.slug for f in baselined) == PORT_BASELINED
    assert twin.DEFAULT_BASELINE == "analysis_baseline_torch.txt"


def test_reference_baseline_is_unchanged():
    data = (REPO / "analysis_baseline.txt").read_bytes()
    assert hashlib.sha256(data).hexdigest() == REF_BASELINE_SHA256


def test_twin_has_the_reference_modules_and_imports_only_the_stdlib():
    ref_dir = REPO / "src" / "repro" / "analysis"
    twin_dir = REPO / "src" / "repro_torch" / "analysis"
    rel = lambda d: sorted(p.relative_to(d).as_posix() for p in d.rglob("*.py"))
    assert rel(twin_dir) == rel(ref_dir) and len(rel(twin_dir)) == 11
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for path in twin_dir.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert (name.split(".")[0] in stdlib
                        or name.startswith("repro_torch.analysis")), (path, name)


# ---------------------------------------------------------------------------
# 5. the CLI (the reference's four CLI cases run through both above)
# ---------------------------------------------------------------------------
def test_cli_defaults_to_the_port_tree():
    r = _cli("repro_torch.analysis")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stderr.strip() == _cli("repro_torch.analysis",
                                    "src/repro_torch").stderr.strip()
    assert "0 finding(s), 2 baselined" in r.stderr
