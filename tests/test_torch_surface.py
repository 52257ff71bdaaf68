"""The port's public surface against the JAX package's.

Both packages are read with ``ast``; neither is imported, so the test is
cheap and cannot pull jax into the port. For every module of
``vkvolume_tpu/`` the port's counterpart is the module at the same
relative path, or the modules of ``RENAMES``. Three things must hold:

* every public top-level function and class of the JAX module, and every
  public method of such a class, has a counterpart in the port (defined
  there, or imported into it from elsewhere in the port);
* every public name a JAX ``__init__`` imports is bound by the port's
  matching ``__init__``;
* every parameter of each such JAX function or method, and of each class's
  constructor (its ``__init__``, or a dataclass's fields), is accepted by
  the port's.

Private names (a leading underscore: Pallas bodies such as ``_kernel``,
``_ladder_up``, ``_fit_forced``, the JAX tracing helpers) are not part of
the surface. What the port leaves out on purpose is in ``EXCLUDED``, each
entry with its reason; an entry the walker would not report fails the test,
so the dict cannot go stale.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "vkvolume_tpu"
PORT_PKG = ROOT / "vkvolume_tpu_torch"

# JAX module -> the port modules that hold its counterparts, where the port
# renamed or split it (the kernels' modules are named for their route).
RENAMES = {
    # the w-grid frame (host plan, pixel stage) and the per-slab sweep K7
    "render/sweep_pallas.py": ("render/sweep_frame.py",
                               "render/sweep_slabs.py"),
    "render/warp_pallas.py": ("render/warp_cuda.py",),        # K2, K8
    "render/marcher_xla.py": ("render/marcher.py",),
    "accel/distance_pallas.py": ("accel/distance_cuda.py",),  # K3-K6
    # what is left of the frustum module (the frustum rays) moved to the
    # ray set-up
    "render/frustum.py": ("render/ray_setup.py",),
}

# JAX name -> the port's, in a renamed kernel module: the wrappers are
# named for their route.
NAME_RENAMES = {
    "accel/distance_pallas.py": {
        "isotropic_distance_pallas": "isotropic_distance_cuda",
        "anisotropic_distance_pallas": "anisotropic_distance_cuda",
        "relax_pallas": "relax",
        # the z-relaxation through a (Y, Z, X) transpose, a TPU layout
        # choice: the same function as relax_z_direct
        "relax_z": "relax_z_direct",
    },
}

_MOSAIC = "a Mosaic compile workaround (each Pallas compile takes ~10 s)"
_REPLAN = ("a Mosaic compile workaround: the re-plan chain after a refused "
           "compile")
_DMA = ("a Pallas internal: the TPU kernel's DMA window or pipelining; the "
        "CUDA kernels size their own")
_SCHEDULE = ("the CUDA kernels compute the fixed schedules the JAX callers "
             "use")
_WGRID = ("the w-grid planner that plan_from_stats replaced; nothing in the "
          "JAX package calls it")

# A parameter of every JAX function the port leaves out.
EXCLUDED_PARAMS = {
    "interpret": "a Pallas internal: interpret mode; the port's CPU tensors "
                 "run the plain versions",
}

# JAX module -> {finding: reason}. A finding is "name", "Class.method" or
# "function(parameter)" / "Class.method(parameter)".
EXCLUDED = {
    "engine/engine.py": {
        "Engine.prewarm_interactive": _MOSAIC,
    },
    "bench/harness.py": {
        "freeze_statics": _MOSAIC,
        "freeze_orbit_statics": _MOSAIC,
    },
    "render/sweep_pallas.py": {
        "select_view_plan_forced": _MOSAIC,
        "plan_from_stats(force)": _MOSAIC + " (the frozen plan tiers)",
        "plan_from_stats(no_brick)": _REPLAN,
        "sweep_pallas(R)": _DMA,
    },
    "render/warp_pallas.py": {
        "required_R": _DMA,
        "warp_to_pixels(R)": _DMA,
        "resample_rows(RECT)": _DMA,
        "resample_rows(pipeline)": _DMA,
        "warp_two_pass(RECT_A)": _DMA,
        "warp_two_pass(RECT_B)": _DMA,
        "warp_two_pass(pipeline)": _DMA,
        "warp_two_pass_b(RECT_A)": _DMA,
        "warp_two_pass_b(RECT_B)": _DMA,
        "warp_two_pass_b(pipeline)": _DMA,
    },
    "accel/distance_pallas.py": {
        "scan_and_relax(scan_dir)": _SCHEDULE,
        "scan_and_relax(relax_dirs)": _SCHEDULE,
        "scan_and_relax_multi(scan_dirs)": _SCHEDULE,
        "scan_and_relax_multi(relax_dirs)": _SCHEDULE,
        "relax_z_direct(relax_dirs)": _SCHEDULE,
        "relax_z_direct_multi(relax_dirs)": _SCHEDULE,
        "relax_z(relax_dirs)": _SCHEDULE,
    },
    "utils/__init__.py": {
        "enable_compile_cache": "the persistent XLA compilation cache "
                                "(nvcc builds are cached in build/)",
    },
    "render/frustum.py": {
        "WGrid": _WGRID,
        "build_wgrid": _WGRID,
    },
}


# ---- the walker -----------------------------------------------------------

def _bindings(body) -> dict:
    """name -> what a module or class body binds it to: the def or class
    node, ("import", module, level, name) for a from-import, or
    ("assign", value) for an assignment."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = ("import", node.module,
                                           node.level, a.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ("assign", node.value)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = ("assign", node.value)
    return out


def _params(fn, skip_first=False) -> tuple[set, bool]:
    """A def's parameter names, and whether it takes ``**kwargs``."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return set(names[1:] if skip_first else names), a.kwarg is not None


def _ctor_params(cls) -> tuple[set, bool] | None:
    """A class's constructor parameters: its ``__init__``'s, or a
    dataclass's fields; None when the class body defines neither."""
    init = _bindings(cls.body).get("__init__")
    if isinstance(init, ast.FunctionDef):
        return _params(init, skip_first=True)
    if any("dataclass" in ast.unparse(d) for d in cls.decorator_list):
        return {n.target.id for n in cls.body
                if isinstance(n, ast.AnnAssign)
                and isinstance(n.target, ast.Name)}, False
    return None


class Package:
    """The modules of a package, parsed: relative path -> module body."""

    def __init__(self, sources: dict):
        self.bodies = {rel: ast.parse(src).body
                       for rel, src in sources.items()}

    @classmethod
    def read(cls, root: pathlib.Path) -> "Package":
        return cls({p.relative_to(root).as_posix(): p.read_text()
                    for p in sorted(root.rglob("*.py"))})

    def resolve(self, rel: str, name: str, depth: int = 0):
        """What ``name`` is bound to in module ``rel``, following the
        package's own relative imports and plain aliases: a def or class
        node, True for a binding that cannot be followed (any other
        assignment, an outside import, a module), None when the module
        does not bind it or imports it from a module of the package that
        does not."""
        b = _bindings(self.bodies.get(rel, [])).get(name)
        if b is None or not isinstance(b, tuple):
            return b
        if depth < 8 and b[0] == "assign" and isinstance(b[1], ast.Name):
            return self.resolve(rel, b[1].id, depth + 1) or True
        if depth < 8 and b[0] == "import" and b[2] > 0:
            base = pathlib.PurePosixPath(rel).parent
            for _ in range(b[2] - 1):
                base = base.parent
            if b[1]:
                base = base.joinpath(*b[1].split("."))
            for cand in (f"{base}.py", f"{base}/__init__.py"):
                cand = cand.removeprefix("./")
                if cand in self.bodies:
                    got = self.resolve(cand, b[3], depth + 1)
                    if got is not None:
                        return got
            sub = f"{base}/{b[3]}".removeprefix("./")
            return True if (f"{sub}.py" in self.bodies
                            or f"{sub}/__init__.py" in self.bodies) else None
        return True


def surface_findings(jax: Package, port: Package, rel: str) -> list[str]:
    """What the port lacks of JAX module ``rel``'s public surface."""
    found = []

    def lookup(name):
        name = NAME_RENAMES.get(rel, {}).get(name, name)
        for pr in RENAMES.get(rel, (rel,)):
            got = port.resolve(pr, name)
            if got is not None:
                return got
        return None

    def check_params(label, want, have):
        if isinstance(have, tuple) and not have[1]:
            found.extend(f"{label}({p})" for p in sorted(want - have[0]))

    binds = _bindings(jax.bodies[rel])
    for name, node in binds.items():
        if name.startswith("_"):
            continue
        if isinstance(node, tuple):
            # An import: part of the surface in an __init__ only.
            if rel.endswith("__init__.py") and node[0] == "import" \
                    and lookup(name) is None:
                found.append(name)
            continue
        other = lookup(name)
        if other is None:
            found.append(name)
        elif isinstance(node, ast.FunctionDef):
            if isinstance(other, ast.FunctionDef):
                check_params(name, _params(node)[0], _params(other))
        elif isinstance(other, ast.ClassDef):
            ctor = _ctor_params(node)
            if ctor is not None:
                check_params(name, ctor[0], _ctor_params(other))
            mine = _bindings(other.body)
            for m, mnode in _bindings(node.body).items():
                if m.startswith("_") or not isinstance(mnode,
                                                       ast.FunctionDef):
                    continue
                if m not in mine:
                    found.append(f"{name}.{m}")
                elif isinstance(mine[m], ast.FunctionDef):
                    check_params(f"{name}.{m}", _params(mnode)[0],
                                 _params(mine[m]))
    return found


# ---- the tests -------------------------------------------------------------

_JAX = Package.read(JAX_PKG)
_PORT = Package.read(PORT_PKG)


def _excluded(rel: str, finding: str) -> bool:
    if finding in EXCLUDED.get(rel, {}):
        return True
    return finding.endswith(")") and \
        finding[finding.rindex("(") + 1:-1] in EXCLUDED_PARAMS


@pytest.mark.parametrize("rel", sorted(_JAX.bodies))
def test_port_covers_the_jax_module(rel):
    for pr in RENAMES.get(rel, (rel,)):
        assert pr in _PORT.bodies, f"no port module {pr} for {rel}"
    found = surface_findings(_JAX, _PORT, rel)
    missing = [f for f in found if not _excluded(rel, f)]
    assert not missing, f"{rel}: the port lacks {missing}"
    stale = sorted(set(EXCLUDED.get(rel, {})) - set(found))
    assert not stale, f"{rel}: excluded but present in the port: {stale}"


def test_exclusions_are_named_and_used():
    """Every exclusion names a JAX module and a reason, and every excluded
    parameter is one the port still leaves out somewhere."""
    for table in (EXCLUDED, RENAMES, NAME_RENAMES):
        assert set(table) <= set(_JAX.bodies)
    reasons = [r for ex in EXCLUDED.values() for r in ex.values()]
    assert all(reasons) and all(EXCLUDED_PARAMS.values())
    params = {f[f.rindex("(") + 1:-1]
              for rel in _JAX.bodies
              for f in surface_findings(_JAX, _PORT, rel) if f.endswith(")")}
    assert set(EXCLUDED_PARAMS) <= params


_JAX_TOY = {
    "__init__.py": "from .m import kept, dropped\n",
    "m.py": ("def kept(a, b=1):\n    pass\n\n"
             "def dropped(x):\n    pass\n\n"
             "class C:\n"
             "    def __init__(self, size):\n        pass\n\n"
             "    def run(self, n, *, fast=False):\n        pass\n"),
}
# The port's side: the whole surface, through an import and an alias.
_PORT_TOY = {
    "__init__.py": "from .m import kept, dropped\n",
    "m.py": ("from .impl import kept, C\n\n"
             "def _dropped(x):\n    pass\n\n"
             "dropped = _dropped\n"),
    "impl.py": ("def kept(a, b=2):\n    pass\n\n"
                "class C:\n"
                "    def __init__(self, size, **kw):\n        pass\n\n"
                "    def run(self, n, fast=True):\n        pass\n"),
}


def _toy_findings(edit: tuple) -> dict:
    """The toy port with one edit (module, old text, new text) made, and
    the walker's findings in each toy module."""
    port = dict(_PORT_TOY)
    mod, old, new = edit
    assert old in port[mod]
    port[mod] = port[mod].replace(old, new)
    jax, port = Package(_JAX_TOY), Package(port)
    return {rel: surface_findings(jax, port, rel) for rel in _JAX_TOY}


def test_walker_passes_a_complete_port():
    assert _toy_findings(("m.py", "", "")) == {"__init__.py": [],
                                               "m.py": []}


@pytest.mark.parametrize("edit,want", [
    # a public name missing from the module and from the __init__
    ((("m.py", "dropped = _dropped\n", ""),
      {"__init__.py": ["dropped"], "m.py": ["dropped"]})),
    # a parameter of a function, of a method, of a constructor
    ((("impl.py", "def kept(a, b=2)", "def kept(a)"),
      {"__init__.py": [], "m.py": ["kept(b)"]})),
    ((("impl.py", "def run(self, n, fast=True)", "def run(self, n)"),
      {"__init__.py": [], "m.py": ["C.run(fast)"]})),
    ((("impl.py", "def __init__(self, size, **kw)",
       "def __init__(self, n)"),
      {"__init__.py": [], "m.py": ["C(size)"]})),
    # a method
    ((("impl.py", "    def run(self, n, fast=True):\n        pass\n", ""),
      {"__init__.py": [], "m.py": ["C.run"]})),
], ids=["name", "parameter", "method-parameter", "constructor-parameter",
        "method"])
def test_walker_reports_what_the_port_lacks(edit, want):
    assert _toy_findings(edit) == want
