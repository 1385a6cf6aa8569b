"""Declarative config trees with validation and hot update.

The port's own copy of ``tpu3fs/utils/config.py``,
unchanged but for its imports.

Re-expresses the reference's ConfigBase (src/common/utils/ConfigBase.h:582):
declared items with defaults and checkers, TOML render/parse, dotted-path
overrides (``--config.a.b=v``), and hot updates that invoke registered
callbacks only for items flagged hot-updatable. mgmtd distributes rendered
config blobs per node type (src/fbs/core/service/CoreServiceDef.h:4-7); our
mgmtd does the same with these trees.

Usage::

    class StorageConfig(Config):
        io_depth = ConfigItem(32, hot=True, checker=lambda v: v > 0)
        class aio(Config):
            threads = ConfigItem(8)

Values live in each instance's ``__dict__`` (so plain attribute access reads
the configured value, shadowing the class-level declarations).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

try:  # py311+: stdlib toml reader
    import tomllib
except ImportError:  # pragma: no cover
    try:  # py310: the tomli backport has the identical API
        import tomli as tomllib
    except ImportError:
        tomllib = None


class ConfigItem:
    def __init__(
        self,
        default: Any,
        *,
        hot: bool = False,
        checker: Callable[[Any], bool] | None = None,
        doc: str = "",
    ):
        self.default = default
        self.hot = hot
        self.checker = checker
        self.doc = doc


class Config:
    """A config node: items + nested sections, with hot-update semantics."""

    def __init__(self, **overrides: Any):
        self._items: Dict[str, ConfigItem] = {}
        self._sections: Dict[str, "Config"] = {}
        self._callbacks: List[Callable[["Config"], None]] = []
        self._lock = threading.RLock()
        for name in dir(type(self)):
            if name.startswith("_"):
                continue
            decl = getattr(type(self), name)
            if isinstance(decl, ConfigItem):
                self._items[name] = decl
                # instance attribute shadows the class-level declaration
                setattr(self, name, decl.default)
            elif isinstance(decl, type) and issubclass(decl, Config):
                sec = decl()
                self._sections[name] = sec
                setattr(self, name, sec)
        for key, val in overrides.items():
            self.set(key, val)

    # -- access ------------------------------------------------------------
    def get(self, dotted: str) -> Any:
        node: Any = self
        for part in dotted.split("."):
            node = getattr(node, part)
        return node

    def _resolve(self, dotted: str):
        """-> (owning node, leaf name, ConfigItem); raises KeyError."""
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._sections:
                raise KeyError(f"unknown config section: {dotted}")
            node = node._sections[part]
        leaf = parts[-1]
        if leaf not in node._items:
            raise KeyError(f"unknown config item: {dotted}")
        return node, leaf, node._items[leaf]

    @staticmethod
    def _coerce_and_check(item: ConfigItem, dotted: str, value: Any) -> Any:
        # coerce to the default's type first, so checkers see typed values
        # (flag/TOML inputs arrive as strings)
        if item.default is not None and value is not None:
            want = type(item.default)
            if not isinstance(value, want):
                if want is bool and isinstance(value, str):
                    value = value.lower() in ("1", "true", "yes")
                else:
                    value = want(value)
        if item.checker is not None and not item.checker(value):
            raise ValueError(f"config check failed for {dotted}={value!r}")
        return value

    def set(self, dotted: str, value: Any, *, hot_only: bool = False) -> None:
        node, leaf, item = self._resolve(dotted)
        if hot_only and not item.hot:
            raise ValueError(f"config item not hot-updatable: {dotted}")
        value = self._coerce_and_check(item, dotted, value)
        with node._lock:
            setattr(node, leaf, value)

    # -- hot update --------------------------------------------------------
    def add_callback(self, fn: Callable[["Config"], None]) -> None:
        """Callback invoked when a hot update touches this node's subtree."""
        self._callbacks.append(fn)

    def hot_update(self, updates: Dict[str, Any]) -> None:
        """Apply dotted-path updates; every path must be hot-updatable.

        Validation happens before any value changes, so a failed update leaves
        the tree untouched (ref ConfigBase.h guard semantics). Callbacks fire
        on every node along the path of each changed item (leaf-most first),
        plus the root, each at most once.
        """
        staged = []
        notify: List[Config] = []
        for dotted, value in updates.items():
            node, leaf, item = self._resolve(dotted)
            if not item.hot:
                raise ValueError(f"config item not hot-updatable: {dotted}")
            value = self._coerce_and_check(item, dotted, value)
            staged.append((node, leaf, value))
            # nodes along the path, leaf-most first
            path_nodes = [self]
            cur = self
            for part in dotted.split(".")[:-1]:
                cur = cur._sections[part]
                path_nodes.append(cur)
            for n in reversed(path_nodes):
                if n not in notify:
                    notify.append(n)
        for node, leaf, value in staged:
            with node._lock:
                setattr(node, leaf, value)
        for n in notify:
            for fn in n._callbacks:
                fn(n)

    # -- render / parse ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {name: getattr(self, name) for name in self._items}
        for name, sec in self._sections.items():
            out[name] = sec.to_dict()
        return out

    def render_toml(self, _prefix: str = "") -> str:
        lines = []
        for name in sorted(self._items):
            lines.append(f"{name} = {_toml_value(getattr(self, name))}")
        for name in sorted(self._sections):
            sec = self._sections[name]
            path = f"{_prefix}{name}"
            lines.append("")
            lines.append(f"[{path}]")
            lines.append(sec.render_toml(path + "."))
        return "\n".join(lines).strip() + "\n"

    def load_dict(self, data: Dict[str, Any]) -> None:
        for key, val in data.items():
            if isinstance(val, dict) and key in self._sections:
                self._sections[key].load_dict(val)
            else:
                self.set(key, val)

    def load_toml(self, text: str) -> None:
        if tomllib is None:  # pragma: no cover
            raise NotImplementedError("tomllib unavailable")
        self.load_dict(tomllib.loads(text))

    def apply_flag_overrides(self, argv: List[str]) -> List[str]:
        """Consume ``--config.a.b=v`` style flags; returns unconsumed argv."""
        rest = []
        for arg in argv:
            if arg.startswith("--config.") and "=" in arg:
                dotted, value = arg[len("--config."):].split("=", 1)
                self.set(dotted, value)
            else:
                rest.append(arg)
        return rest


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"unsupported config value type: {type(v)}")
