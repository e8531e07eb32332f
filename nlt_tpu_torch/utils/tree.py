"""Nested dict/list/tuple trees of tensors (the port's params, optimizer
state and statics). Dict keys are walked in sorted order, as jax.tree
does, so leaf lists line up with nlt_tpu's."""


def tree_leaves(tree):
    """The tensors of `tree`, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn applied leafwise over `tree` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
