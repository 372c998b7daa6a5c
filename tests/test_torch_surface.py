"""The port's surface against the JAX package's, read from both sources.

Neither package is imported (only ``ast`` reads them), so this runs where
jax is absent as well.  Three checks:

(a) every module of the JAX package has a counterpart file in the port, under
    the same path (``ops/pallas/`` maps to ``ops/cuda/``);
(b) every public top-level function and class of a JAX module, and every
    public method of such a class, exists under the same name in the
    counterpart (a method may come from a base class of the port), or is in
    ``NOT_PORTED`` with its reason;
(c) every default argument of a function or method found in both is the
    same source text, apart from ``DEFAULTS_DIFFER``.

A JAX name added later fails (b) until the port follows it.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "trajnetplusplusbaselines_tpu")
PORT_ROOT = os.path.join(REPO, "trajnetplusplusbaselines_torch")
MODULE_MAP = (("ops/pallas/", "ops/cuda/"),)

DO_NOT_PORT = "Do not port"  # the TPU toolchain's code (ROADMAP, "Do not port")
MOVED = "moved to "  # followed by "<module>:<name>" in the port
DEVIATION = "deliberate deviation"  # ROADMAP Queue 3
DEAD = "dead in JAX"
REASONS = (DO_NOT_PORT, MOVED, DEVIATION, DEAD)

# (JAX module, name) -> why the port has no same-named counterpart
NOT_PORTED = {
    ("models/lstm.py", "LSTM.forward_stepwise"):
        DO_NOT_PORT + ": a workaround for the remote AOT compiler",
    ("models/lstm.py", "LSTM.forward_segmented"):
        DO_NOT_PORT + ": a workaround for the remote AOT compiler",
    ("utils/checkpoint.py", "save_orbax"): DO_NOT_PORT + ": Orbax",
    ("utils/checkpoint.py", "load_orbax"): DO_NOT_PORT + ": Orbax",
    ("utils/checkpoint.py", "load_full_state"): DO_NOT_PORT + ": Orbax",
    ("utils/checkpoint.py", "restore_opt_state"): DO_NOT_PORT + ": Orbax",
    ("trainers/common.py", "enable_compilation_cache"):
        DO_NOT_PORT + ": the compile-cache plumbing",
    ("trainers/common.py", "chunk_sizes_for"): DO_NOT_PORT + ": the scan recipe",
    ("trainers/common.py", "make_bucket_epoch_runner"): DO_NOT_PORT + ": the scan recipe",
    ("trainers/common.py", "stack_packed"): DO_NOT_PORT + ": the scan recipe",
    ("trainers/common.py", "ResidentDataset.place"): DO_NOT_PORT + ": the scan recipe",
    ("models/lstm.py", "LSTMPredictor.save"): MOVED + "utils/checkpoint.py:save_predictor",
    ("models/lstm.py", "LSTMPredictor.load"): MOVED + "utils/checkpoint.py:load_predictor",
    ("models/sgan.py", "SGANPredictor.save"): MOVED + "utils/checkpoint.py:save_predictor",
    ("models/sgan.py", "SGANPredictor.load"): MOVED + "utils/checkpoint.py:load_predictor",
    ("models/vae.py", "VAEPredictor.save"): MOVED + "utils/checkpoint.py:save_predictor",
    ("models/vae.py", "VAEPredictor.load"): MOVED + "utils/checkpoint.py:load_predictor",
    ("ops/pooling/grid.py", "GridBasedPooling.position_only"): MOVED + "models/lstm.py:LSTM.route",
    ("models/classical/kalman.py", "kf_fit_and_predict"):
        DEVIATION + ": the KF folds every track of a dataset (predict_dataset)",
    ("models/classical/kalman.py", "kf_predict_batch"):
        DEVIATION + ": the KF folds every track of a dataset (predict_dataset)",
    ("ops/embeddings.py", "start_enc"): DEAD + ": called from nowhere",
    ("ops/embeddings.py", "start_dec"): DEAD + ": called from nowhere",
}

# (JAX module, name, argument) -> why the defaults differ
DEFAULTS_DIFFER = {
    ("models/sgan.py", "get_noise", "dtype"):
        "an explicit torch.float32 where JAX takes its default dtype",
}


def modules(root):
    """Relative paths of every module under root."""
    out = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.relpath(os.path.join(dirpath, f), root).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def counterpart(rel):
    for jax_dir, port_dir in MODULE_MAP:
        if rel.startswith(jax_dir):
            return port_dir + rel[len(jax_dir):]
    return rel


def _parse(root, rel):
    with open(os.path.join(root, rel)) as f:
        return ast.parse(f.read(), rel)


def _is_function(node):
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def surface(tree):
    """{name: def node} of the public top-level functions and classes, and
    of each class's public methods as ``Class.method`` (``__init__``
    included, other underscored names not)."""
    names = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if _is_function(node):
            names[node.name] = node
        elif isinstance(node, ast.ClassDef):
            names[node.name] = node
            for item in node.body:
                if _is_function(item) and (item.name == "__init__"
                                           or not item.name.startswith("_")):
                    names[f"{node.name}.{item.name}"] = item
    return names


class Package:
    """One package's sources, with the base classes of its classes
    resolved through its own relative and absolute imports."""

    def __init__(self, root):
        self.root = root
        self.name = os.path.basename(root)
        self.trees = {rel: _parse(root, rel) for rel in modules(root)}

    def _module_path(self, rel, level, module):
        """The relative path of an imported module of this package, or None."""
        if level:
            parts = rel.split("/")[:-1]
            parts = parts[: len(parts) - (level - 1)]
        elif module and (module == self.name or module.startswith(self.name + ".")):
            parts, module = [], module[len(self.name) + 1:]
        else:
            return None
        base = "/".join(parts + (module.split(".") if module else []))
        for path in (base + ".py", (base + "/" if base else "") + "__init__.py"):
            if path in self.trees:
                return path
        return None

    def _bindings(self, rel):
        """{local name: (module path, attribute or None)} of ``rel``'s
        imports from this package."""
        out = {}
        for node in self.trees[rel].body:
            if isinstance(node, ast.ImportFrom):
                src = self._module_path(rel, node.level, node.module)
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub = self._module_path(rel, node.level,
                                            ".".join(filter(None, [node.module, alias.name])))
                    if sub is not None and (src is None or src.endswith("__init__.py")):
                        out[local] = (sub, None)  # a module of the package
                    elif src is not None:
                        out[local] = (src, alias.name)
        return out

    def _class(self, rel, name, seen=()):
        """(module path, ClassDef) of class ``name`` as seen from ``rel``."""
        if (rel, name) in seen:
            return None
        for node in self.trees[rel].body:
            if isinstance(node, ast.ClassDef) and node.name == name:
                return rel, node
        target = self._bindings(rel).get(name)
        if target is not None and target[1] is not None:
            return self._class(target[0], target[1], seen + ((rel, name),))
        return None

    def _base(self, rel, expr):
        if isinstance(expr, ast.Name):
            return self._class(rel, expr.id)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            target = self._bindings(rel).get(expr.value.id)
            if target is not None and target[1] is None:
                return self._class(target[0], expr.attr)
        return None  # a class from outside the package

    def method(self, rel, cls, name):
        """The def of ``cls.name`` in ``rel``, searched through the class's
        bases within the package, or None."""
        found = self._class(rel, cls)
        if found is None:
            return None
        mod, node = found
        for item in node.body:
            if _is_function(item) and item.name == name:
                return item
        for base in node.bases:
            resolved = self._base(mod, base)
            if resolved is not None:
                hit = self.method(resolved[0], resolved[1].name, name)
                if hit is not None:
                    return hit
        return None

    def lookup(self, rel, name):
        """The def or class of ``name`` (``Class.method`` allowed) in module
        ``rel`` of this package, or None."""
        if rel not in self.trees:
            return None
        if "." in name:
            return self.method(rel, *name.split(".", 1))
        return surface(self.trees[rel]).get(name)


def defaults(fn):
    """{argument: default as source text} of a def."""
    args = fn.args
    positional = args.posonlyargs + args.args
    out = {a.arg: ast.unparse(d)
           for a, d in zip(positional[len(positional) - len(args.defaults):], args.defaults)}
    out.update({a.arg: ast.unparse(d)
                for a, d in zip(args.kwonlyargs, args.kw_defaults) if d is not None})
    return out


def missing_names(jax, port):
    """[(JAX module, name)] without a counterpart of the same name."""
    return [(rel, name) for rel, tree in jax.trees.items()
            for name in surface(tree)
            if port.lookup(counterpart(rel), name) is None and not name.endswith(".__init__")]


def differing_defaults(jax, port):
    """[(JAX module, name, argument, JAX default, port default)]."""
    out = []
    for rel, tree in jax.trees.items():
        for name, node in surface(tree).items():
            other = port.lookup(counterpart(rel), name)
            if not _is_function(node) or other is None or not _is_function(other):
                continue
            theirs = defaults(other)
            out += [(rel, name, arg, text, theirs[arg])
                    for arg, text in defaults(node).items()
                    if arg in theirs and theirs[arg] != text]
    return out


@pytest.fixture(scope="module")
def packages():
    return Package(JAX_ROOT), Package(PORT_ROOT)


def test_every_jax_module_has_a_counterpart(packages):
    jax, port = packages
    assert len(jax.trees) > 50
    missing = [rel for rel in jax.trees if counterpart(rel) not in port.trees]
    assert not missing, missing


def test_every_public_name_is_ported_or_listed(packages):
    jax, port = packages
    missing = missing_names(jax, port)
    unlisted = [m for m in missing if m not in NOT_PORTED]
    assert not unlisted, unlisted
    # no entry outlives its reason: each names a JAX name the port lacks
    assert sorted(NOT_PORTED) == sorted(missing)


def test_every_not_ported_entry_gives_one_reason(packages):
    _, port = packages
    for (rel, name), reason in NOT_PORTED.items():
        assert sum(reason.startswith(kind) for kind in REASONS) == 1, (rel, name, reason)
        if reason.startswith(MOVED):
            target_module, target = reason[len(MOVED):].split(":")
            assert port.lookup(target_module, target) is not None, (rel, name, reason)


def test_defaults_are_the_same_source(packages):
    jax, port = packages
    differ = differing_defaults(jax, port)
    unlisted = [d for d in differ if d[:3] not in DEFAULTS_DIFFER]
    assert not unlisted, unlisted
    assert sorted(DEFAULTS_DIFFER) == sorted(d[:3] for d in differ)


def _fake_package(root, files):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return Package(str(root))


def test_checks_see_missing_names_inherited_methods_and_defaults(tmp_path):
    """The checks on two small packages: a method inherited from a base
    class imported from a sibling module counts as present; a missing
    function, a missing method and a changed default are reported."""
    jax = _fake_package(tmp_path / "jaxpkg", {
        "__init__.py": "",
        "ops/__init__.py": "",
        "ops/pallas/k.py": "def kernel(x, n=4):\n    pass\n",
        "trainers/__init__.py": "",
        "trainers/common.py": "",
        "trainers/a.py": ("class Trainer:\n"
                          "    def __init__(self, criterion='L2', lr=1e-3):\n        pass\n"
                          "    def loop(self, epochs=25):\n        pass\n"
                          "    def train(self):\n        pass\n"
                          "def helper():\n    pass\n"),
    })
    port = _fake_package(tmp_path / "portpkg", {
        "__init__.py": "",
        "ops/__init__.py": "",
        "ops/cuda/k.py": "def kernel(x, n=4):\n    pass\n",
        "trainers/__init__.py": "",
        "trainers/common.py": ("class EpochLoop:\n"
                               "    def loop(self, epochs=25):\n        pass\n"),
        "trainers/a.py": ("from .common import EpochLoop\n"
                          "class Trainer(EpochLoop):\n"
                          "    def __init__(self, criterion='pred', lr=1e-3):\n        pass\n"),
    })
    assert port.lookup("trainers/a.py", "Trainer.loop") is not None
    assert sorted(missing_names(jax, port)) == [("trainers/a.py", "Trainer.train"),
                                                ("trainers/a.py", "helper")]
    assert differing_defaults(jax, port) == [
        ("trainers/a.py", "Trainer.__init__", "criterion", "'L2'", "'pred'")]
