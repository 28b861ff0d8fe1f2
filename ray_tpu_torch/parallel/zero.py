"""ZeRO-style cross-replica sharding of the weight update and optimizer
state (counterpart of ``ray_tpu/parallel/zero.py``; arxiv 2004.13336).

In plain data parallelism every replica holds the full optimizer state
and applies the identical update N times.  Sharding the update gives each
rank 1/N of the parameters to own: gradients arrive by **reduce-scatter**
(each rank only materializes the mean gradient of its shard), the
optimizer runs on the shard with the rank's 1/N optimizer state, and the
fresh parameters are **all-gathered** back so the forward and backward
still see fully replicated weights.

Layout (the JAX package's, unchanged): the sharded leaves are flattened,
in tree order (dict keys sorted, as ``jax.tree_util``), into ONE flat
vector of ``total`` elements, zero-padded to ``world * chunk`` with
``chunk = ceil(total / world)``; the padding tail lives on the last
rank(s).  Leaves a ``should_shard`` predicate rejects (it gets the leaf's
``jax.tree_util.keystr``-style path, ``['h']['w']``), and all scalars,
stay replicated with replicated optimizer state and a mean gradient.

Where the JAX package runs one ``shard_map`` program over a ``data`` mesh
axis, the port runs one process per rank: the update is eager PyTorch in
each rank's step, and the collectives are ``torch.distributed`` calls
over a process group (``ray_tpu_torch.ops.collectives``).  Every
collective here is data movement plus a sum in rank order, so the ranks
agree bit for bit.  The fp32 ZeRO-2 wire is one ``all_to_all`` of the
``[W, chunk]`` rows and a local sum in rank order (the int8 wire's shape,
and deterministic), not a backend ``reduce_scatter``.

The optimizer is a ``torch.optim`` optimizer, given as a factory ``tx``:
``tx(list_of_tensors) -> Optimizer`` (``functools.partial(adamw,
learning_rate=3e-4)``, or ``lambda ps: torch.optim.Adam(ps, 1e-2)``);
``chain(zero_clip_by_global_norm(c), factory)`` puts the global-norm clip
before it, as ``optax.chain`` does.  Each rank's ``ZeroOptState`` holds
one optimizer over its flat shard (one tensor) and the replicated leaves.
Adam, AdamW and SGD are supported: they are elementwise, so the sharded
update is the replicated one, and their state maps onto optax's layout
(``(ScaleByAdamState(count, mu, nu), EmptyState...)``), which is how a
checkpoint keeps the JAX package's layout: shard leaves as ``(total,)``
globals with ``[start, stop]`` indices, so each package restores the
other's fp32 ZeRO checkpoints.

Only this module's copy of the JAX package's JAX-free pieces is used:
nothing is imported from ``ray_tpu``.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ray_tpu_torch.ops import collectives

DATA_AXIS = "data"


# ---------------------------------------------------------------------------
# trees: jax.tree_util's order (dict keys sorted; None is an empty subtree)
# ---------------------------------------------------------------------------
def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_flatten(tree: Any) -> Tuple[List[tuple], List[Any], Any]:
    """``(key paths, leaves, treedef)`` of a nest of dicts, lists and
    tuples.  A key path is a tuple of dict keys and sequence indices."""
    paths: List[tuple] = []
    leaves: List[Any] = []

    def rec(node, keys):
        if isinstance(node, dict):
            ks = sorted(node)
            return ("dict", ks, [rec(node[k], keys + (k,)) for k in ks])
        if isinstance(node, (list, tuple)):
            kind = type(node) if _is_namedtuple(node) else (
                "list" if isinstance(node, list) else "tuple")
            return (kind, None, [rec(c, keys + (i,))
                                 for i, c in enumerate(node)])
        if node is None:
            return ("none", None, [])
        paths.append(keys)
        leaves.append(node)
        return ("leaf", None, [])

    return paths, leaves, rec(tree, ())


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)

    def rec(node):
        kind, keys, children = node
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: rec(c) for k, c in zip(keys, children)}
        built = [rec(c) for c in children]
        if kind == "list":
            return built
        if kind == "tuple":
            return tuple(built)
        return kind(*built)

    return rec(treedef)


def tree_map_with_path(fn: Callable[[tuple, Any], Any], tree: Any) -> Any:
    paths, leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p, x) for p, x in zip(paths, leaves)])


def keystr(keys: tuple) -> str:
    """``jax.tree_util.keystr`` of a key path of dicts and sequences:
    ``['h_0']['w'][2]``."""
    return "".join(f"[{k!r}]" for k in keys)


def _is_shard_path(keys: tuple) -> bool:
    """True for opt-state leaves under the combined tree's ``"shard"``
    branch (the 1/N flat-vector partition)."""
    return "shard" in keys


def _ndim(x) -> int:
    return len(getattr(x, "shape", ()))


def _torch_dtype(leaf) -> torch.dtype:
    dt = getattr(leaf, "dtype", torch.float32)
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device) if device is not None \
        else torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the optimizer: a torch.optim factory, optionally behind gradient
# transforms, and its state in optax's layout
# ---------------------------------------------------------------------------
class chain:
    """``optax.chain`` of gradient transforms ending in an optimizer
    factory: ``chain(zero_clip_by_global_norm(0.5), lambda ps:
    torch.optim.Adam(ps, 1e-2))``.  Each transform maps the combined
    ``{"shard", "repl"}`` gradient (and the group) to a new one; it holds
    no state (optax's ``EmptyState``)."""

    def __init__(self, *parts):
        if not parts:
            raise ValueError("chain needs an optimizer factory")
        self.transforms = tuple(parts[:-1])
        self.factory = parts[-1]

    def __call__(self, params):
        return self.factory(params)


def _split_tx(tx) -> Tuple[tuple, Callable]:
    if isinstance(tx, chain):
        return tx.transforms, tx.factory
    return (), tx


def _kind(optimizer: torch.optim.Optimizer) -> str:
    if isinstance(optimizer, torch.optim.AdamW):
        return "adamw"
    if isinstance(optimizer, torch.optim.Adam):
        return "adam"
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd_momentum" if optimizer.defaults.get("momentum") \
            else "sgd"
    raise ValueError(f"{type(optimizer).__name__}: the ZeRO update supports "
                     "torch.optim.Adam, AdamW and SGD (elementwise, with "
                     "optax's state layout)")


_MOMENTS = {"adam": ("exp_avg", "exp_avg_sq"),
            "adamw": ("exp_avg", "exp_avg_sq"),
            "sgd": (), "sgd_momentum": ("momentum_buffer",)}


def _probe_kind(tx) -> str:
    _, factory = _split_tx(tx)
    return _kind(factory([torch.zeros(1)]))


def _layout(kind: str, count, moments: List[Any], n_transforms: int):
    """optax's state tree for ``kind``: adam ``((count, mu, nu), ())``,
    adamw ``((count, mu, nu), (), ())``, sgd ``((), ())``, sgd with
    momentum ``((trace,), ())``; behind ``n_transforms`` stateless
    transforms, ``((), ..., that)``."""
    if kind == "adam":
        tree = ((count, *moments), ())
    elif kind == "adamw":
        tree = ((count, *moments), (), ())
    elif kind == "sgd":
        tree = ((), ())
    else:
        tree = ((moments[0],), ())
    if n_transforms:
        tree = tuple([()] * n_transforms) + (tree,)
    return tree


def _unlayout(kind: str, tree, n_transforms: int):
    """(count or None, [moment trees]) from optax's layout."""
    if n_transforms:
        tree = tree[n_transforms]
    if kind in ("adam", "adamw"):
        return tree[0][0], list(tree[0][1:3])
    if kind == "sgd":
        return None, []
    return None, [tree[0][0]]


class ZeroOptState:
    """One rank's share of a ZeRO optimizer: copies of its rows of the
    flat parameter vector (one row for plain ZeRO; the rank's lanes for
    the elastic step) and of the replicated leaves, and one ``torch.optim``
    optimizer over them.  The counterpart of the local block of the JAX
    package's global opt state; ``local_tree()`` gives it in optax's
    layout, with the shard leaves ``[k, chunk]``."""

    def __init__(self, sharder: "ZeroSharder", tx, first_row: int,
                 rows: Sequence[torch.Tensor],
                 repl: Sequence[torch.Tensor]):
        self.sharder = sharder
        self.first_row = int(first_row)
        self.transforms, factory = _split_tx(tx)
        self.rows = [r.detach().clone() for r in rows]
        self.repl = [r.detach().clone() for r in repl]
        self.optimizer = factory(self.rows + self.repl)
        self.kind = _kind(self.optimizer)

    @property
    def params(self) -> List[torch.Tensor]:
        return self.rows + self.repl

    def apply(self, g_rows: Sequence[torch.Tensor],
              g_repl: Sequence[torch.Tensor]) -> None:
        """One optimizer step with these gradients (already reduced and
        transformed) on the rows and replicated leaves."""
        for p, g in zip(self.params, list(g_rows) + list(g_repl)):
            p.grad = g.to(p.dtype)
        self.optimizer.step()
        for p in self.params:
            p.grad = None

    def _count(self) -> int:
        if self.kind not in ("adam", "adamw"):
            return 0
        st = self.optimizer.state.get(self.rows[0], {})
        step = st.get("step", 0)
        return int(step.item() if isinstance(step, torch.Tensor) else step)

    def _moment(self, p: torch.Tensor, name: str) -> torch.Tensor:
        got = self.optimizer.state.get(p, {}).get(name)
        return torch.zeros_like(p) if got is None else got

    def local_tree(self) -> Any:
        """This rank's state in optax's layout: shard leaves ``[k,
        chunk]`` (zeros before the first step, as ``tx.init``), count
        int32, replicated-leaf moments whole."""
        moments = [{"repl": tuple(self._moment(p, m) for p in self.repl),
                    "shard": torch.stack([self._moment(p, m)
                                          for p in self.rows])}
                   for m in _MOMENTS[self.kind]]
        count = torch.tensor(self._count(), dtype=torch.int32)
        return _layout(self.kind, count, moments, len(self.transforms))

    def load_local_tree(self, tree: Any) -> None:
        """Set the optimizer's state from a local tree in optax's layout
        (shard leaves ``[k, chunk]``)."""
        count, moments = _unlayout(self.kind, tree, len(self.transforms))
        for i, p in enumerate(self.params):
            state: Dict[str, Any] = {}
            if count is not None:
                state["step"] = torch.tensor(float(count),
                                             dtype=torch.float32)
            for name, m in zip(_MOMENTS[self.kind], moments):
                src = m["shard"][i] if i < len(self.rows) \
                    else m["repl"][i - len(self.rows)]
                state[name] = _as_tensor(src).to(
                    p.device, p.dtype).reshape(p.shape).clone()
            self.optimizer.state[p] = state

    def load_global_tree(self, opt_global: Any) -> None:
        """Take this rank's rows of a GLOBAL tree (shard leaves
        ``[sharder.world, chunk]``, as ``restore_opt_state`` gives)."""
        k = len(self.rows)
        lo = self.first_row
        self.load_local_tree(tree_map_with_path(
            lambda kp, x: x[lo:lo + k]
            if (_is_shard_path(kp) and _ndim(x) >= 2) else x, opt_global))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy's dtype for a torch dtype (numpy has no bfloat16: its bits
    as uint16, the checkpoint store's raw form)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


class ZeroSharder:
    """Partition bookkeeping for a ZeRO update over ``world`` ranks.

    Built from a parameter template (tensors, numpy arrays or anything
    with ``shape`` and ``dtype``).  ``should_shard(path)`` keeps rejected
    leaves, and all scalars, replicated."""

    def __init__(self, params_template: Any, world: int,
                 should_shard: Optional[Callable[[str], bool]] = None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = int(world)
        paths, leaves, self.treedef = tree_flatten(params_template)
        self._sharded_mask: List[bool] = []
        sizes, dtypes = [], []
        for kp, leaf in zip(paths, leaves):
            shard = _ndim(leaf) >= 1 and (should_shard is None
                                          or should_shard(keystr(kp)))
            self._sharded_mask.append(bool(shard))
            if shard:
                sizes.append(int(np.prod(leaf.shape)))
                dtypes.append(_torch_dtype(leaf))
        self._shapes = [tuple(leaf.shape) for leaf in leaves]
        self._dtypes = [_torch_dtype(leaf) for leaf in leaves]
        if not sizes:
            raise ValueError("ZeroSharder: no sharded leaves (all scalars "
                             "or rejected by should_shard)")
        dtype = dtypes[0]
        for dt in dtypes[1:]:
            dtype = torch.promote_types(dtype, dt)
        self.dtype = dtype
        self.total = int(sum(sizes))
        self.chunk = -(-self.total // self.world)
        self.padded = self.chunk * self.world
        self._offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

    # ---- flat-vector plumbing ----
    def split(self, tree: Any) -> Tuple[torch.Tensor, Tuple]:
        """(flat ``[padded]`` vector of the sharded leaves, tuple of the
        replicated leaves): the inverse of ``merge``."""
        parts, repl = [], []
        for leaf, shard in zip(tree_flatten(tree)[1], self._sharded_mask):
            if shard:
                parts.append(_as_tensor(leaf).detach().reshape(-1)
                             .to(self.dtype))
            else:
                repl.append(leaf)
        if self.padded > self.total:
            parts.append(parts[0].new_zeros(self.padded - self.total))
        flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        return flat, tuple(repl)

    def merge(self, flat: torch.Tensor, repl: Sequence) -> Any:
        """Rebuild the full tree from a ``[padded]`` flat vector and the
        replicated leaves (cast back to each leaf's dtype and shape)."""
        repl = list(repl)
        leaves, si = [], 0
        for i, shard in enumerate(self._sharded_mask):
            if shard:
                start = int(self._offsets[si])
                stop = int(self._offsets[si + 1])
                leaves.append(flat[start:stop].reshape(self._shapes[i])
                              .to(self._dtypes[i]))
                si += 1
            else:
                leaves.append(repl.pop(0))
        return tree_unflatten(self.treedef, leaves)

    def rows(self, flat: torch.Tensor) -> torch.Tensor:
        return flat.reshape(self.world, self.chunk)

    # ---- sharded optimizer state ----
    def init_opt_state(self, tx, params: Any, rank: Optional[int] = None,
                       rows_per_rank: int = 1) -> ZeroOptState:
        """Rank ``rank``'s (default: this process's rank in the default
        group) fresh optimizer share over its ``rows_per_rank`` rows."""
        if rank is None:
            rank = collectives.rank_of()
        flat, repl = self.split(params)
        lo = rank * rows_per_rank
        rows = list(self.rows(flat)[lo:lo + rows_per_rank])
        return ZeroOptState(self, tx, lo, rows,
                            [_as_tensor(r) for r in repl])

    def _opt_template(self, tx) -> Any:
        """Zeros of the GLOBAL opt state in optax's layout (numpy; a
        bfloat16 leaf as its uint16 bits): shard leaves ``[world,
        chunk]``."""
        transforms, _ = _split_tx(tx)
        kind = _probe_kind(tx)
        repl = [(s, d) for s, d, m in zip(self._shapes, self._dtypes,
                                          self._sharded_mask) if not m]
        moments = [{"repl": tuple(np.zeros(s, _np_dtype(d))
                                  for s, d in repl),
                    "shard": np.zeros((self.world, self.chunk),
                                      _np_dtype(self.dtype))}
                   for _ in _MOMENTS[kind]]
        return _layout(kind, np.zeros((), np.int32), moments,
                       len(transforms))

    # ---- accounting (the JAX package's numbers) ----
    def opt_bytes_per_replica(self, tx) -> int:
        """Bytes of optimizer state ONE rank holds under this sharder
        (chunk-sized slices of the sharded leaves, the replicated leaves'
        whole, optax's count)."""
        total = 0
        for kp, leaf in zip(*tree_flatten(self._opt_template(tx))[:2]):
            n = int(np.prod(leaf.shape)) if leaf.ndim else 1
            if _is_shard_path(kp) and leaf.ndim >= 2:
                n = n // self.world
            total += n * leaf.dtype.itemsize
        return total

    def replicated_opt_bytes(self, tx) -> int:
        """Bytes of the replicated baseline optimizer state (what every
        rank holds without ZeRO): the 1/N denominator."""
        kind = _probe_kind(tx)
        n_mom = len(_MOMENTS[kind])
        per_moment = sum(int(np.prod(s) or 1) * torch.empty(
            0, dtype=d).element_size()
            for s, d in zip(self._shapes, self._dtypes))
        return n_mom * per_moment + (4 if kind in ("adam", "adamw") else 0)

    def comm_accounting(self, zero_sharding: str = "opt+grads",
                        quantized: str = "off",
                        block: int = collectives.DEFAULT_BLOCK) -> dict:
        return collectives.comm_bytes_accounting(
            self.total, self.world, zero_sharding=zero_sharding,
            quantized=quantized, block=block)

    # ---- checkpoint resharding ----
    def valid_range(self, rank: int) -> Tuple[int, int]:
        """Unpadded ``[start, stop)`` of ``rank``'s chunk against the
        global ``(total,)`` vector (the last rank(s) absorb the
        padding)."""
        start = min(rank * self.chunk, self.total)
        return start, min((rank + 1) * self.chunk, self.total)

    def opt_shard_for_rank(self, opt_global: Any, rank: int) -> Any:
        """Rank ``rank``'s trimmed local opt tree (shard leaves are the
        1-D valid slice, padding dropped): what that rank persists."""
        start, stop = self.valid_range(rank)
        return tree_map_with_path(
            lambda kp, x: x[rank][: stop - start]
            if (_is_shard_path(kp) and _ndim(x) >= 2) else x, opt_global)

    def opt_save_index_fn(self, rank: int, local_tree: Any):
        """Save-side ``IndexFn`` for ``ShardWriter``: shard leaves map to
        their ``[start, stop]`` slice of the ``(total,)`` global vector,
        everything else is replicated (rank 0 persists it once)."""
        from ray_tpu_torch.checkpoint.tree import flatten_with_paths

        mask = tree_map_with_path(
            lambda kp, x: _is_shard_path(kp) and _ndim(x) >= 1, local_tree)
        sharded_paths = {p for p, v in flatten_with_paths(mask) if v}
        start, stop = self.valid_range(rank)

        def fn(path: str, arr):
            if path not in sharded_paths:
                return None
            return (self.total,), [[start, stop]]

        return fn

    def reshard_opt_state(self, assembled: Any) -> Any:
        """Re-chunk an assembled opt state (shard leaves as full
        ``(total,)`` vectors) onto THIS sharder's world: pad to ``[world,
        chunk]``; replicated leaves pass through."""

        def redistribute(kp, x):
            if _is_shard_path(kp) and _ndim(x) == 1 \
                    and int(x.shape[0]) == self.total:
                x = _as_tensor(x)
                pad = self.padded - self.total
                if pad:
                    x = torch.cat([x, x.new_zeros(pad)])
                return x.reshape(self.world, self.chunk)
            return x

        return tree_map_with_path(redistribute, assembled)


def assemble_opt(opt_global: Any, total: int) -> Any:
    """A global opt tree (shard leaves ``[rows, chunk]``) in the
    world-agnostic *assembled* form: shard leaves the unpadded ``(total,)``
    vectors that ``reshard_opt_state`` re-chunks onto any world."""
    return tree_map_with_path(
        lambda kp, x: _as_tensor(x).reshape(-1)[:total]
        if (_is_shard_path(kp) and _ndim(x) >= 2) else x, opt_global)


def gather_opt_state(opt: ZeroOptState, group=None) -> Any:
    """The GLOBAL opt tree (shard leaves ``[sharder.world, chunk]``) on
    every rank: each rank's ``local_tree`` rows, all-gathered in rank
    order.  A collective: every rank of the group calls it."""
    world = collectives.world_of(group)
    local = opt.local_tree()
    if world == 1:
        return local
    return tree_map_with_path(
        lambda kp, x: collectives.all_gather_rows(x, group).flatten(0, 1)
        if (_is_shard_path(kp) and _ndim(x) >= 2) else x, local)


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------
def zero_clip_by_global_norm(max_norm: float) -> Callable:
    """``optax.clip_by_global_norm`` for the combined ``{"shard", "repl"}``
    gradient of a ZeRO update: the shard partition's squared norm is
    summed across the group (each rank holds 1/N of the flat vector;
    padding contributes 0), replicated leaves count once, which is the
    global norm the replicated path clips by."""

    def clip(updates: Dict[str, Any], group=None) -> Dict[str, Any]:
        shard_sq = updates["shard"].float().square().sum()
        if collectives.world_of(group) > 1:
            shard_sq = collectives.all_reduce_sum(shard_sq, group)
        repl_sq = sum((x.float().square().sum() for x in updates["repl"]),
                      torch.zeros((), device=shard_sq.device))
        g_norm = torch.sqrt(shard_sq + repl_sq)
        keep = g_norm < max_norm

        def one(t):
            return torch.where(keep, t, t / g_norm.to(t.dtype) * max_norm)

        return {"shard": one(updates["shard"]),
                "repl": tuple(one(x) for x in updates["repl"])}

    return clip


def _write_back(params: Any, new: Any) -> Any:
    """Copy ``new``'s leaves into ``params``' tensors in place (the
    donation of the JAX step); returns ``params``."""
    with torch.no_grad():
        for p, n in zip(tree_flatten(params)[1], tree_flatten(new)[1]):
            if isinstance(p, torch.Tensor):
                p.copy_(n)
    return params


def make_update_fn(sharder: ZeroSharder, tx, *, group=None,
                   zero_sharding: str = "opt+grads",
                   quantized: str = "off",
                   block: int = collectives.DEFAULT_BLOCK):
    """The ZeRO gradient application of one rank.

    ``update(grads, opt, params, generator=None) -> (params, opt)``:
    ``grads`` and ``params`` are this rank's (replicated) trees, ``opt``
    its ``ZeroOptState``.  Reduce-scatter the flat gradient (mean; int8
    when ``quantized``), apply the optimizer to this rank's shard and the
    replicated remainder, all-gather the fresh shards, and write them into
    ``params`` in place.  ``zero_sharding="opt"`` all-reduces the full
    gradient first (ZeRO-1 wire; same algebra), ``"opt+grads"``
    reduce-scatters (ZeRO-2).  ``generator`` turns on stochastic rounding
    on the int8 wire.  At ``world == 1`` no collective runs (the JAX
    package's bypass, ``zero.py:343``)."""
    if zero_sharding not in ("opt", "opt+grads"):
        raise ValueError(f"zero_sharding must be opt|opt+grads, "
                         f"got {zero_sharding!r}")
    if quantized not in ("off", "int8"):
        raise ValueError(f"quantized must be off|int8, got {quantized!r}")
    world = sharder.world

    def update(grads, opt: ZeroOptState, params,
               generator: Optional[torch.Generator] = None):
        g_flat, g_repl = sharder.split(grads)
        p_flat, p_repl = sharder.split(params)
        g_repl = tuple(_as_tensor(g) for g in g_repl)
        if world > 1:
            g_repl = tuple(collectives.all_reduce_sum(g, group) / world
                           for g in g_repl)
        rows = sharder.rows(g_flat)
        idx = collectives.rank_of(group) if world > 1 else 0
        if world == 1:
            g_shard = rows[0]
        elif zero_sharding == "opt+grads":
            if quantized == "int8":
                g_shard = collectives.quantized_reduce_scatter_mean(
                    rows, group, block, generator)
            else:
                got = collectives.all_to_all_rows(rows, group)
                g_shard = got[0]
                for i in range(1, world):
                    g_shard = g_shard + got[i]
                g_shard = g_shard / world
        else:  # "opt": full all-reduce, then this rank's row
            if quantized == "int8":
                g_mean = collectives.quantized_pmean(g_flat, group, block,
                                                     generator)
            else:
                g_mean = collectives.all_reduce_sum(g_flat, group) / world
            g_shard = sharder.rows(g_mean)[idx]
        with torch.no_grad():
            opt.rows[0].copy_(sharder.rows(p_flat)[idx])
            for mine, p in zip(opt.repl, p_repl):
                mine.copy_(_as_tensor(p))
        c_grads = {"shard": g_shard.to(sharder.dtype), "repl": g_repl}
        for t in opt.transforms:
            c_grads = t(c_grads, group)
        opt.apply([c_grads["shard"]], c_grads["repl"])
        if world > 1:
            new_flat = collectives.all_gather_rows(opt.rows[0],
                                                   group).reshape(-1)
        else:
            new_flat = opt.rows[0]
        return _write_back(params, sharder.merge(new_flat, opt.repl)), opt

    return update


# ---- metrics ----
def export_zero_metrics(sharder: ZeroSharder, tx, *, zero_sharding: str,
                        quantized: str) -> dict:
    """The memory and wire envelope; publishes the
    ``zero_opt_bytes_per_replica`` and ``grad_comm_bytes`` gauges when a
    runtime is connected, and returns the numbers either way."""
    acct = sharder.comm_accounting(zero_sharding=zero_sharding,
                                   quantized=quantized)
    out = {
        "zero_opt_bytes_per_replica": sharder.opt_bytes_per_replica(tx),
        "replicated_opt_bytes": sharder.replicated_opt_bytes(tx),
        "grad_comm_bytes": acct["grad_comm_bytes"],
        "param_comm_bytes": acct["param_comm_bytes"],
        "grad_comm_reduction_vs_fp32": acct["reduction_vs_fp32"],
    }
    try:
        from ray_tpu_torch.util.metrics import Gauge

        Gauge("zero_opt_bytes_per_replica",
              "optimizer-state bytes held per replica under ZeRO "
              "sharding").set(float(out["zero_opt_bytes_per_replica"]))
        Gauge("grad_comm_bytes",
              "gradient-reduction bytes moved per replica per update "
              "(analytic ring model)").set(float(out["grad_comm_bytes"]))
    except Exception:
        pass  # no connected runtime: the numbers still return
    return out


# ---- the distributed checkpointer's round trip ----
def save_opt_state(root: str, step: int, sharder: ZeroSharder,
                   opt_global: Any, extra: Optional[dict] = None) -> dict:
    """Persist a GLOBAL sharded opt state: one ``ShardWriter`` per rank
    writes that rank's trimmed shard with exact ``[start, stop]`` indices
    against the unpadded ``(total,)`` flat vector, then the manifest
    commits.  Driver-side form (iterates the ranks in-process); in a gang
    each rank calls ``save_opt_shard``."""
    from ray_tpu_torch.checkpoint import manifest as mf
    from ray_tpu_torch.checkpoint.saver import ShardWriter

    stats = []
    for rank in range(sharder.world):
        local = sharder.opt_shard_for_rank(opt_global, rank)
        writer = ShardWriter(root, rank=rank, world_size=sharder.world)
        stats.append(writer.persist(
            writer.snapshot(local), step,
            index_fn=sharder.opt_save_index_fn(rank, local),
            extra=dict(extra or {}, zero_total=sharder.total)))
    manifest = mf.commit_manifest(root, step, sharder.world,
                                  meta={"zero_total": sharder.total})
    return {"manifest": manifest, "ranks": stats}


def save_opt_shard(root: str, step: int, opt: ZeroOptState,
                   group=None, extra: Optional[dict] = None) -> dict:
    """In-gang save: this rank persists its own trimmed shard, the group
    meets at a barrier, and rank 0 commits the manifest.  Every rank of
    the group calls it."""
    import torch.distributed as dist

    from ray_tpu_torch.checkpoint import manifest as mf
    from ray_tpu_torch.checkpoint.saver import ShardWriter

    sharder = opt.sharder
    rank = collectives.rank_of(group)
    start, stop = sharder.valid_range(rank)
    local = tree_map_with_path(
        lambda kp, x: x[0][: stop - start]
        if (_is_shard_path(kp) and _ndim(x) >= 2) else x, opt.local_tree())
    writer = ShardWriter(root, rank=rank, world_size=sharder.world)
    stat = writer.persist(writer.snapshot(local), step,
                          index_fn=sharder.opt_save_index_fn(rank, local),
                          extra=dict(extra or {}, zero_total=sharder.total))
    if collectives.world_of(group) > 1:
        dist.barrier(group=group)
    if rank == 0:
        mf.commit_manifest(root, step, sharder.world,
                           meta={"zero_total": sharder.total})
    if collectives.world_of(group) > 1:
        dist.barrier(group=group)
    return stat


def restore_opt_state(root: str, sharder: ZeroSharder, tx,
                      step: Optional[int] = None) -> Any:
    """Restore a sharded opt state saved from ANY world size (by either
    package) as a GLOBAL tree for ``sharder.world`` ranks: assemble the
    ``(total,)`` globals from whichever rank shards cover them, then
    re-chunk (the N->M elastic-restart path).  A rank takes its rows with
    ``ZeroOptState.load_global_tree``."""
    from ray_tpu_torch.checkpoint.restore import restore_tree

    target = tree_map_with_path(
        lambda kp, x: np.zeros((sharder.total,), x.dtype)
        if (_is_shard_path(kp) and x.ndim >= 2) else x,
        sharder._opt_template(tx))
    assembled = restore_tree(root, step=step, target=target)
    return sharder.reshard_opt_state(assembled)


class ZeroUpdate(NamedTuple):
    """The sharder, the update and the optimizer-share constructor.  The
    JAX package's fourth field, ``opt_specs`` (the state's placement on
    the mesh), has no counterpart: each rank holds only its share."""
    sharder: ZeroSharder
    update: Callable
    init_opt: Callable[..., ZeroOptState]


def build_zero_update(params_template: Any, tx, world: int, *,
                      zero_sharding: str = "opt+grads",
                      quantized: str = "off", group=None,
                      should_shard: Optional[Callable[[str], bool]] = None
                      ) -> ZeroUpdate:
    """Sharder, update and optimizer-share constructor in one, with the
    memory and wire gauges exported."""
    sharder = ZeroSharder(params_template, world, should_shard=should_shard)
    update = make_update_fn(sharder, tx, group=group,
                            zero_sharding=zero_sharding, quantized=quantized)
    export_zero_metrics(sharder, tx, zero_sharding=zero_sharding,
                        quantized=quantized)
    return ZeroUpdate(
        sharder, update,
        lambda params, rank=None: sharder.init_opt_state(
            tx, params, collectives.rank_of(group) if rank is None
            else rank))
