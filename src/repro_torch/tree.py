"""Trees of tensors as the port keeps them: nested dicts (string keys, in
insertion order) and lists, with tensors at the leaves. A leaf's path is
the tuple of its keys and list indices; ``path_str`` joins them with
"/", which is the JAX package's ``checkpoint._path_str`` of the same
leaf where the two trees have the same shape."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

__all__ = ["get_path", "leaves", "leaves_with_path", "path_str", "tree_map",
           "tree_map_with_path"]

Path = Tuple[Any, ...]


def leaves_with_path(tree: Any, prefix: Path = ()) -> Iterator[
        Tuple[Path, torch.Tensor]]:
    """(path, tensor) of every leaf, dicts in insertion order."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from leaves_with_path(val, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from leaves_with_path(val, prefix + (i,))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif tree is not None:
        raise TypeError(f"not a tree of tensors at {path_str(prefix)}: "
                        f"{type(tree).__name__}")


def path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over the structure of
    ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, path: Path = (), *,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> Any:
    """``fn(path, leaf)`` over the structure of ``tree``; a node for which
    ``is_leaf`` is true is a leaf, whatever its type."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(path, tree)


def get_path(tree: Any, path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_path(tree)]
