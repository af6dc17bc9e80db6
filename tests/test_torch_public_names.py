"""Every public name of every ulcx module resolves in the port's module of
the same path.

ulcx's sources are parsed with ``ast`` (ulcx itself is not imported, so
no JAX compile): a module's public names are its top-level defs,
classes and assignments not starting with an underscore, and for an
``__init__.py`` also the names it re-exports. The port's module of the
same dotted path under ``ulcx_torch`` must have each of them, but for
the exemptions below, each with its reason. The FSM's mode and record
constants must also have ulcx's values.
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
ULCX = ROOT / "ulcx"

# what the port leaves out on purpose: module -> {name or "*": reason}
EXEMPT = {
    "bitstream.pallas_encode3": {"*": "the TPU's Pallas encode kernels; the port's are CUDA C++ "
                                      "(csrc/encode_walks.cu, bitstream/encode_kernels.py)"},
    "bitstream.pallas_decode": {"*": "the TPU's Pallas decode kernels; the port's are CUDA C++ "
                                     "(csrc/decode_walks.cu, bitstream/decode_kernels.py)"},
    "tools._runtime": {"*": "JAX's compilation cache and platform set-up for the CLI tools; "
                            "the port builds its kernels once a process (_build.py)"},
    "utils.compileopts": {"*": "XLA and Mosaic compiler options; the port has no XLA compile"},
    "utils.config": {"mosaic_interpret": "whether Pallas kernels run in interpret mode; a CPU "
                                         "tensor runs the port's plain walks instead"},
    "bitstream.encode": {
        "BlockData": "the JAX scan encoder's per-block state; the port's single-block encode "
                     "runs the walks on fast_encode.FastBlockData",
        "EmitPre": "the JAX scan encoder's precomputed emission planes (the walks' planes here)",
        "prepare_block": "builds BlockData for the JAX scan encoder (fast_encode.prepare_fast "
                         "here)",
    },
    "bitstream.decode": {"FsmCarry": "the JAX scan's carry of the state machine; the port's "
                                     "machine runs in the FSM kernel"},
}


def _modules():
    """(dotted path under the package, source file) of every ulcx module."""
    for f in sorted(ULCX.rglob("*.py")):
        parts = list(f.relative_to(ULCX).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), f


MODULES = dict(_modules())


def public_names(path: pathlib.Path) -> set[str]:
    """Top-level defs, classes and assigned names of a source file (and
    for an ``__init__.py`` the names it imports), without underscores."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_port_has_public_names(mod):
    exempt = EXEMPT.get(mod, {})
    if "*" in exempt:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"ulcx_torch.{mod}")
        return
    port = importlib.import_module(".".join(filter(None, ("ulcx_torch", mod))))
    names = public_names(MODULES[mod])
    assert set(exempt) <= names, f"stale exemptions: {set(exempt) - names}"
    missing = sorted(n for n in names - set(exempt) if not hasattr(port, n))
    assert not missing, f"ulcx_torch.{mod} lacks {missing}"


def test_exemptions_name_modules_of_ulcx():
    assert set(EXEMPT) <= set(MODULES)
    assert all(reason for e in EXEMPT.values() for reason in e.values())


def test_fsm_constants_equal_ulcx():
    """The M_* modes and REC_* record types of ulcx's decode module have
    the same values in the port's (read from ulcx's source)."""
    from ulcx_torch.bitstream import decode

    want = {}
    for node in ast.parse(MODULES["bitstream.decode"].read_text()).body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith(("M_", "REC_"))):
            want[node.targets[0].id] = node.value.value
    assert len([k for k in want if k.startswith("M_")]) == 15
    assert len([k for k in want if k.startswith("REC_")]) == 5
    assert {k: getattr(decode, k) for k in want} == want
