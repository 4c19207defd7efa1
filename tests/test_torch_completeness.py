"""The port's completeness against the JAX package, read from its sources.

Every public top-level function, class and upper-case constant of
``optical_flow_tpu/**/*.py``, and every entry of a module's ``__all__``,
must have a counterpart: the same name importable from the port's mirrored
module (``optical_flow_tpu/x/y.py`` -> ``optical_flow_tpu_torch.x.y``), a
TPU kernel's CUDA wrapper (``KERNELS``), or a reasoned entry of
``NOT_PORTED``.  The JAX package is read with ``ast`` and never imported.
ROADMAP.md's "Not to port" section lists the table item for item.
"""
import ast
import importlib
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "optical_flow_tpu"

GATHER = "TPU gather workarounds (displaced, blocked, one-hot and batched modes); the port indexes directly"
NATIVE = "the C host readers; each has a numpy fallback, which the port's io/ is"
AOTCACHE = ("JAX's persistent executable cache; the port's kernel build directory is keyed by the "
            "source hash (ops/cuda/build.py::build_key), which does the same in every new process")
DISPATCH = ("JAX dispatch plumbing: the fused monoliths, the level-resampled / prepare / jit helpers and "
            "the uint8 host-link ship exist to shape JAX's jit cache; the port's *_flow_program and "
            "*_level_step run the same work eagerly")
GATES = "Pallas VMEM and tile gates; the port's cg_plan / rof_plan / wide_fits choose from the shape and the card"
SWITCHES = ("OFTPU_*_IMPL route switches; the port picks its route by device and offers no switch to "
            "the plain version")
SHARDINGS = "NamedSharding descriptors; the port's FlowMesh places the shards itself"

# A JAX module (and its submodules), or a (module, name) pair, that the port
# leaves behind on purpose -> why.  Modules are relative to optical_flow_tpu.
NOT_PORTED = {
    "ops.gather": GATHER,
    "native": NATIVE,
    "utils.aotcache": AOTCACHE,
    **{(f"methods.{m}", f"{m}_flow_from_{kind}"): DISPATCH
       for m in ("ba", "hs", "classic_nl", "alt_ba") for kind in ("rgb", "gray")},
    **{(f"methods.{m}", f"{m}_level_resampled"): DISPATCH for m in ("ba", "hs", "classic_nl", "alt_ba")},
    ("methods.ba", "irls_prepare"): DISPATCH,
    ("methods.hs", "hs_prepare"): DISPATCH,
    ("methods.base", "jit_scale255"): DISPATCH,
    ("methods.base", "jit_median_pair"): DISPATCH,
    ("interface", "_ship_exact"): DISPATCH,
    ("ops.pallas.cg_kernel", "cg_pallas_ok"): GATES,
    ("ops.pallas.rof_kernel", "rof_vmem_ok"): GATES,
    ("ops.pallas.wmedian_kernel", "wmedian_pallas_ok"): GATES,
    ("ops.pallas.wmedian_kernel", "TILE_H"): GATES,
    ("ops.pallas.wmedian_kernel", "TILE_W"): GATES,
    ("solvers.cg", "CG_IMPL"): SWITCHES,
    ("ops.wmedian", "WMEDIAN_IMPL"): SWITCHES,
    ("ops.gather", "GATHER_IMPL"): SWITCHES,
    ("parallel.mesh", "space_sharding"): SHARDINGS,
    ("parallel.mesh", "batch_space_sharding"): SHARDINGS,
    ("parallel.mesh", "replicated"): SHARDINGS,
}

# Each function that reaches pl.pallas_call, and each public wrapper of one,
# -> the port's CUDA wrapper that launches its kernel (ops/cuda/*_kernel.py).
KERNELS = {
    ("ops.pallas.wmedian_kernel", "_wmedian_call"): "ops.cuda.wmedian_kernel.wmedian",
    ("ops.pallas.wmedian_kernel", "wmedian_pallas"): "ops.cuda.wmedian_kernel.wmedian",
    ("ops.pallas.cg_kernel", "_cg_call"): "ops.cuda.cg_kernel.cg_solve",
    ("ops.pallas.cg_kernel", "cg_solve_pallas"): "ops.cuda.cg_kernel.cg_solve",
    ("ops.pallas.rof_kernel", "rof_structure_2d_pallas"): "ops.cuda.rof_kernel.rof_structure",
    ("ops.pallas.rof_kernel", "_rof_tiled_call"): "ops.cuda.rof_kernel.rof_structure",
    ("ops.pallas.rof_kernel", "rof_structure_2d_tiled"): "ops.cuda.rof_kernel.rof_structure",
}


def _module_name(path):
    """``optical_flow_tpu/x/y.py`` -> ``x.y`` (``""`` for the package itself)."""
    parts = path.relative_to(JAX_ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _jax_sources():
    return {_module_name(p): ast.parse(p.read_text()) for p in sorted(JAX_ROOT.rglob("*.py"))}


SOURCES = _jax_sources()


def _body(tree):
    """The module's top-level statements, those under a top-level if / try included."""
    for node in tree.body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from ast.iter_child_nodes(node)
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def public_names(tree):
    """The public top-level functions, classes and upper-case constants, and the ``__all__`` entries."""
    names = set()
    for node in _body(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
            for target in _assigned(node):
                if target.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
                elif target.id.isupper() and not target.id.startswith("_"):
                    names.add(target.id)
    return names


def defined_names(tree):
    """Every name the module binds at top level, private ones included."""
    names = set()
    for node in _body(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= {t.id for t in _assigned(node)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def pallas_functions():
    """(module, function) of every top-level function whose body calls ``pl.pallas_call``."""
    found = set()
    for mod, tree in SOURCES.items():
        for node in _body(tree):
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute) and c.func.attr == "pallas_call"
                    for c in ast.walk(node)):
                found.add((mod, node.name))
    return found


def _not_ported(mod, name):
    return any(key == (mod, name) or (isinstance(key, str) and (mod == key or mod.startswith(key + ".")))
               for key in NOT_PORTED)


def _port_module(mod):
    return importlib.import_module("optical_flow_tpu_torch" + (f".{mod}" if mod else ""))


def _port_object(dotted):
    mod, name = dotted.rsplit(".", 1)
    return getattr(_port_module(mod), name)


@pytest.mark.parametrize("mod", sorted(SOURCES))
def test_every_public_jax_name_has_a_counterpart(mod):
    """Each public name of the JAX module imports from the port's mirrored
    module, is a TPU kernel mapped to its CUDA wrapper, or is not ported
    for a reason the table gives."""
    names = {name for name in public_names(SOURCES[mod])
             if (mod, name) not in KERNELS and not _not_ported(mod, name)}
    if not names:
        return
    port = _port_module(mod)
    missing = sorted(name for name in names if not hasattr(port, name))
    assert not missing, f"optical_flow_tpu.{mod}: no counterpart in the port and no NOT_PORTED entry: {missing}"


def test_not_ported_entries_name_what_jax_has_and_the_port_lacks():
    """No stale entry: each module is still in the JAX package, each name is
    still bound in its module, and the port has no module or name of its own
    under that entry's path (else it is ported, not left behind)."""
    for key, reason in NOT_PORTED.items():
        assert reason and "\n" not in reason
        mod, name = (key, None) if isinstance(key, str) else key
        assert mod in SOURCES, f"NOT_PORTED names {mod!r}, which the JAX package no longer has"
        if name is None:
            with pytest.raises(ImportError):
                _port_module(mod)
            continue
        assert name in defined_names(SOURCES[mod]), f"NOT_PORTED names {mod}.{name}, which the JAX package no longer has"
        try:
            port = _port_module(mod)
        except ImportError:
            continue
        assert not hasattr(port, name), f"{mod}.{name} is in the port: drop its NOT_PORTED entry"


def test_every_pallas_kernel_maps_to_a_cuda_wrapper():
    """Each function that reaches ``pl.pallas_call`` and each public name of a
    Pallas module is either a kernel in ``KERNELS``, whose CUDA wrapper
    imports from the port's ``ops/cuda``, or a gate in ``NOT_PORTED``; no
    kernel is in ``NOT_PORTED``."""
    kernels = pallas_functions()
    assert kernels and kernels <= set(KERNELS), f"a Pallas kernel has no CUDA wrapper: {sorted(kernels - set(KERNELS))}"
    for (mod, name), wrapper in KERNELS.items():
        assert name in defined_names(SOURCES[mod])
        assert wrapper.startswith("ops.cuda.") and callable(_port_object(wrapper))
        assert not _not_ported(mod, name), f"the kernel {mod}.{name} may not be left unported"
    for mod in (m for m in SOURCES if m.startswith("ops.pallas.")):
        for name in public_names(SOURCES[mod]):
            assert (mod, name) in KERNELS or (mod, name) in NOT_PORTED, f"{mod}.{name}"


def _roadmap_not_to_port():
    """The bullets of ROADMAP.md's "Not to port" section."""
    text = (REPO / "ROADMAP.md").read_text()
    section = re.search(r"^### Not to port\n(.*?)(?=^#)", text, re.S | re.M).group(1)
    return [b for b in re.split(r"\n(?=- )", section.strip()) if b.startswith("- ")]


def test_roadmap_not_to_port_matches_the_table():
    """ROADMAP.md lists one bullet a reason of the table, each naming the
    entries with that reason (a module as its path, a name in backticks)."""
    bullets = _roadmap_not_to_port()
    reasons = list(dict.fromkeys(NOT_PORTED.values()))
    assert len(bullets) == len(reasons), f"{len(bullets)} bullets for {len(reasons)} reasons"
    for reason in reasons:
        spelled = []
        for key in (k for k, v in NOT_PORTED.items() if v == reason):
            if isinstance(key, str):
                is_package = (JAX_ROOT / key.replace(".", "/")).is_dir()
                spelled.append(key.replace(".", "/") + ("/" if is_package else ".py"))
            else:
                spelled.append(key[1])
        matching = [b for b in bullets if all(re.search(rf"[`/:]{re.escape(s)}`", b) for s in spelled)]
        assert len(matching) == 1, f"no single ROADMAP bullet names all of {spelled}"
