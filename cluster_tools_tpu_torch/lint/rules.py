"""The ctlint rule classes CT001-CT015 for the port (docs/ANALYSIS.md).

A copy of the reference package's rules with its ids, messages and
scopes (the port keeps the reference's file names).  It differs only where
the port's code differs:

- the package root, the runtime package (CT004's fault registry, CT008)
  and the io package (CT011) are ``cluster_tools_tpu_torch``'s;
- CT003 knows the port's per-card dispatch lock in each form the port
  takes it, and the device pool's per-card lock (see
  :func:`ct003_lock_discipline`);
- CT005 checks device work in the port instead of jit hygiene (see
  :func:`ct005_device_hygiene`).

Rules are pure AST analyses: nothing here imports torch or executes
checked code.  Adding a rule: write ``def ctNNN_name(module: LintModule)
-> list[Finding]``, document the invariant, register it in
:data:`RULES`, and add a firing and a clean fixture and a test case.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import Finding, LintModule


# -- shared AST helpers -------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_seg(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def call_attr(call: ast.Call) -> Optional[str]:
    """Last attribute/name segment of a call target, resolving through
    chained calls (``file_reader(p).require_dataset`` -> 'require_dataset'
    where :func:`dotted` gives None)."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def kw_names(call: ast.Call) -> Tuple[Set[str], bool]:
    """(explicit keyword names, has-**splat)."""
    names, splat = set(), False
    for kw in call.keywords:
        if kw.arg is None:
            splat = True
        else:
            names.add(kw.arg)
    return names, splat


def calls_in(node: ast.AST) -> Iterable[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


#: the package whose tree the path-dependent clauses recognize
PACKAGE = "cluster_tools_tpu_torch"


def _package_root(path: str) -> Optional[str]:
    """Directory of the ``cluster_tools_tpu_torch`` package containing
    ``path`` (for sibling-module resolution), or None outside the package."""
    cur = os.path.dirname(os.path.abspath(path))
    while True:
        if os.path.basename(cur) == PACKAGE:
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def _from_file(path: str, derive):
    """``derive(tree)`` of the sibling module at ``path`` (the fault
    registry, the kernel entries), cached while the file is unchanged so a
    tree walk parses it once; None if it is unreadable or unparsable."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return _from_file_cached(path, st.st_mtime_ns, st.st_size, derive)


@functools.lru_cache(maxsize=32)
def _from_file_cached(path: str, mtime_ns: int, size: int, derive):
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return None
    return derive(tree)


# =============================================================================
# CT001 - executor-contract
# =============================================================================

#: knobs every ``map_blocks`` call site must plumb (docs/ROBUSTNESS.md):
#: without them the call silently runs without failure attribution, hang
#: detection, post-store integrity verification, or locality scheduling.
#: ``sweep_mode`` selects the sharded executor path (one compiled program
#: per Morton batch, docs/PERFORMANCE.md "Sharded sweeps") — enforcing it
#: here means the new path is only reachable through config-plumbed call
#: sites, exactly like the per-block knobs.  ``device_pool`` gates the
#: HBM-resident page pool for ragged sweeps (docs/PERFORMANCE.md
#: "Device-resident data plane"): a site that cannot turn it off from
#: config cannot reach the host-staged twin when HBM is contended.
MAP_BLOCKS_KNOBS = frozenset({
    "failures_path",
    "task_name",
    "block_deadline_s",
    "watchdog_period_s",
    "store_verify_fn",
    "schedule",
    "sweep_mode",
    "device_pool",
})

#: constructor knobs: IO pool width and the per-block retry budget must be
#: config-driven, not the hard-coded defaults.
EXECUTOR_KNOBS = frozenset({"io_threads", "max_retries"})

#: hardened host-path knobs: ``host_block_map`` derives the retry/deadline/
#: schedule knobs from the task config itself, but the two wirings it cannot
#: derive — the post-store integrity verifier and the blocking (which also
#: enables the Morton schedule) — must come from the call site whenever the
#: task owns a chunked output dataset (``require_dataset`` in scope).
HOST_MAP_KNOBS = frozenset({"store_verify_fn", "blocking"})

#: knobs every sharded-global-solve call site must plumb
#: (``parallel/reduce_tree.py``, docs/PERFORMANCE.md "Distributed
#: agglomeration"): the shard/fanout knobs must come from the task config
#: (not hard-coded topology) and the failure attribution must be wired so a
#: degraded solve lands in failures.json as ``degraded:unsharded_solve``
#: instead of vanishing.
SOLVE_KNOBS = frozenset({
    "solver_shards",
    "fanout",
    "failures_path",
    "task_name",
    # the collective reduce plane must be switchable from config: a site
    # that cannot force `packet` cannot drill the degrade ladder, and one
    # that cannot force `collective` cannot prove the fast path
    "reduce_plane",
})

#: files that *define* the executor/solve surface (call sites only are
#: checked; reduce_tree.py's own internal calls are its own contract)
_CT001_DEFINING = ("executor.py", "task.py", "reduce_tree.py")


def ct001_executor_contract(module: LintModule) -> List[Finding]:
    """Executor call sites must plumb the executor's hardening knobs.

    Guards a hand-plumbed convention: every ``BlockwiseExecutor``/
    ``map_blocks`` site must wire the retry / deadline / verify /
    schedule knobs, every ``host_block_map`` site
    that owns a chunked store must wire ``store_verify_fn`` + ``blocking``,
    and every ``solve_with_reduce_tree`` site (the sharded global solve)
    must plumb the shard/fanout knobs from config plus the
    failures-attribution wiring.  Opt out with ``# ctlint: disable=CT001``
    where a knob is genuinely inapplicable (say why in the comment).
    """
    if module.name in _CT001_DEFINING and "lint_fixtures" not in module.path:
        return []
    out: List[Finding] = []
    for call in calls_in(module.tree):
        name = last_seg(dotted(call.func))
        if name == "map_blocks":
            required = MAP_BLOCKS_KNOBS
        elif name == "BlockwiseExecutor":
            required = EXECUTOR_KNOBS
        elif name == "solve_with_reduce_tree":
            required = SOLVE_KNOBS
        elif name == "host_block_map":
            fn = module.enclosing_function(call)
            scope = fn if fn is not None else module.tree
            if not any(
                call_attr(c) == "require_dataset" for c in calls_in(scope)
            ):
                continue  # no chunked store owned here: nothing to verify
            required = HOST_MAP_KNOBS
        else:
            continue
        present, splat = kw_names(call)
        if splat:
            continue  # knobs forwarded wholesale; not statically checkable
        missing = sorted(required - present)
        if missing:
            out.append(Finding(
                "CT001", module.path, call.lineno, call.col_offset,
                f"{name} call site does not plumb the hardened executor "
                f"knob(s) {missing}; wire them from the task config or "
                "opt out explicitly with a reasoned "
                "'# ctlint: disable=CT001'",
            ))
    return out


# =============================================================================
# CT002 - atomic-write discipline
# =============================================================================

def _scope_is_atomic(module: LintModule, node: ast.AST) -> bool:
    """The enclosing scope *calls* the crash-safe idiom: ``os.replace`` /
    ``os.rename`` on the write path, or the shared helper.  Bare attribute
    mentions do not count — ``path.replace('a', 'b')`` is ``str.replace``,
    not an atomic rename."""
    fn = module.enclosing_function(node)
    scope = fn if fn is not None else module.tree
    for c in calls_in(scope):
        name = dotted(c.func)
        if name in ("os.replace", "os.rename"):
            return True
        if last_seg(name) == "atomic_write_json":
            return True
    return False


def ct002_atomic_writes(module: LintModule) -> List[Finding]:
    """Shared JSON state must be written atomically.

    ``failures.json`` / ``io_metrics.json`` / markers / configs / task
    reports are read by concurrent jobs and by resumed runs; a kill
    mid-write must leave the old document or nothing, never half a
    manifest (``fu.atomic_write_json``: temp file + fsync + ``os.replace``).
    Flags ``json.dump`` (and ``f.write(json.dumps(...))``) in any scope
    with no ``os.replace``/``os.rename``/``atomic_write_json`` evidence.
    """
    out: List[Finding] = []
    for call in calls_in(module.tree):
        name = dotted(call.func)
        is_dump = last_seg(name) == "dump" and (
            name or ""
        ).split(".")[0] in ("json", "ujson")
        is_write_dumps = (
            last_seg(name) == "write"
            and call.args
            and isinstance(call.args[0], ast.Call)
            and last_seg(dotted(call.args[0].func)) == "dumps"
        )
        if not (is_dump or is_write_dumps):
            continue
        if _scope_is_atomic(module, call):
            continue
        out.append(Finding(
            "CT002", module.path, call.lineno, call.col_offset,
            "non-atomic JSON write: a kill mid-write leaves a torn "
            "document for concurrent/resumed readers; use "
            "fu.atomic_write_json (temp file + os.replace) or write to a "
            "temp path and os.replace it",
        ))
    return out


# =============================================================================
# CT003 - lock discipline
# =============================================================================

#: modules participating in the runtime's lock graph (reduce_tree.py: the
#: sharded solve's merge queue + metrics locks)
_CT003_SCOPE = (
    "executor.py", "chunk_cache.py", "supervision.py",
    "function_utils.py", "containers.py", "handoff.py", "reduce_tree.py",
)

#: method/function names that block the calling thread (never allowed
#: while holding any tracked lock: a stuck callee freezes every other
#: thread contending for it)
_BLOCKING_CALLS = {"sleep", "result", "wait", "join"}

#: additionally forbidden under the *hot* locks: a card's dispatch lock
#: serializes every kernel launch on that card, its device-pool lock is
#: held from staging until the lanes are gathered, and the chunk-cache
#: lock serializes every cached read — filesystem or (de)serialization
#: work under any of them stalls the whole pipeline
_HOT_BLOCKING = {
    "open", "dump", "dumps", "load", "loads", "listdir", "replace",
    "unlink", "remove", "save", "fsync", "makedirs", "read", "write",
}


#: lock-factory callees whose lock is hot: the executor's per-card
#: ``dispatch_lock(device)`` and the device pool's per-card
#: ``DevicePagePool.lock_for(device)``
_HOT_FACTORIES = ("dispatch_lock", "lock_for")


def _is_hot_lock(module: LintModule, lock_key: str) -> bool:
    if lock_key.endswith(_HOT_FACTORIES):
        return True
    if module.name == "chunk_cache.py" and lock_key == "ChunkCache._lock":
        return True
    return False


def _lock_key(module: LintModule, node: ast.AST) -> Optional[str]:
    """Identity of a lock expression: ``Class.attr`` for ``self.X`` locks,
    the bare name for local/module locks, the callee name for lock-factory
    context managers (``with file_lock(path):``)."""
    name = dotted(node)
    if name is None and isinstance(node, ast.Call):
        name = dotted(node.func)
    if name is None:
        return None
    seg = last_seg(name)
    # a lock is something *named* like one ('_LOCK', 'fail_lock',
    # 'lock_a'); 'block_context' / 'block' / 'blocking' are not locks
    if seg is None:
        return None
    low = seg.lower()
    if not (low.endswith("lock") or low.startswith("lock")) \
            or low.endswith("block"):
        return None
    if name.startswith("self."):
        cls = module.enclosing_class(node)
        return f"{cls.name}.{seg}" if cls is not None else seg
    return seg


def _hot_lock_bindings(module: LintModule) -> Tuple[Set[str], Set[str]]:
    """Names the module binds to a hot lock: ``(locks, containers)``.

    ``lk = dispatch_lock(dev)`` puts ``lk`` in ``locks``;
    ``shard_locks = [dispatch_lock(d) for d in devices]`` (a list or tuple
    of such calls, or a list comprehension) puts ``shard_locks`` in
    ``containers``, so ``with shard_locks[i]:`` holds a
    hot lock.  Module-wide: a name bound so anywhere counts everywhere in
    the module.
    """
    locks: Set[str] = set()
    containers: Set[str] = set()

    def hot_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        key = _lock_key(module, node)
        return key is not None and _is_hot_lock(module, key)

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if hot_call(value):
            kind = locks
        elif isinstance(value, ast.ListComp) and hot_call(value.elt):
            kind = containers
        elif isinstance(value, (ast.List, ast.Tuple)) and value.elts \
                and all(hot_call(e) for e in value.elts):
            kind = containers
        else:
            continue
        for t in targets:
            name = dotted(t)
            if name is not None:
                kind.add(name)
    return locks, containers


def _port_lock_key(module: LintModule, node: ast.AST,
                   bound: Tuple[Set[str], Set[str]]) -> Tuple[Optional[str], bool]:
    """``(key, hot)`` of a ``with`` item in the forms the port takes its
    per-card locks: a name bound to a hot lock, an element of a container
    of them (``shard_locks[shard]``, key ``shard_locks[...]``), and a
    conditional lock (``pool.lock_for(d) if staged else nullcontext()``,
    the key of its first lock-shaped branch).  Else :func:`_lock_key`."""
    locks, containers = bound
    if isinstance(node, ast.IfExp):
        for branch in (node.body, node.orelse):
            key, hot = _port_lock_key(module, branch, bound)
            if key is not None:
                return key, hot
        return None, False
    if isinstance(node, ast.Subscript):
        name = dotted(node.value)
        if name in containers:
            return f"{name}[...]", True
        return None, False
    name = dotted(node)
    if name in locks:
        return name, True
    key = _lock_key(module, node)
    return key, key is not None and _is_hot_lock(module, key)


class _FnInfo:
    __slots__ = ("node", "locks", "calls")

    def __init__(self, node):
        self.node = node
        self.locks: Set[str] = set()   # locks this function acquires
        self.calls: Set[str] = set()   # last-segment names it calls


def ct003_lock_discipline(module: LintModule) -> List[Finding]:
    """No blocking calls under the runtime's locks; no lock-order cycles.

    A card's dispatch lock (``executor.dispatch_lock(device)``, one a
    card for the process) orders every kernel call on that card; anything
    slow under it (or under the chunk cache's LRU lock) serializes the
    sweep, and any pair of locks taken in opposite orders across
    ``executor.py`` / ``chunk_cache.py`` / ``supervision.py`` /
    ``function_utils.py`` / ``containers.py`` / ``handoff.py`` /
    ``reduce_tree.py`` is a latent deadlock.  Builds a static
    lock-acquisition graph (with one level of local call resolution) and
    flags (a) blocking calls made while a lock is held, (b) cycles in the
    lock-order graph.

    Hot locks, under which IO and (de)serialization are banned too: the
    dispatch lock in every form the port takes it — ``with
    dispatch_lock(dev):``, a name bound from ``dispatch_lock(...)``, and
    an element of a list built from it (``with shard_locks[shard]:``) —
    and ``DevicePagePool.lock_for(device)`` in the same forms.  The
    latter counts as hot because the executor holds it around a card's
    ragged staging, every shard's dispatch on that card and the gather of
    the lanes, and the collective reduce plane around a level's program:
    an IO call under it stalls that card's sweep just as one under the
    dispatch lock does.  A conditional lock (``lock if cond else
    nullcontext()``) is the lock.
    """
    is_fixture = "ct003" in module.name
    if module.name not in _CT003_SCOPE and not is_fixture:
        return []
    out: List[Finding] = []

    # function table (qualified by class where applicable)
    fns: Dict[str, _FnInfo] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = module.enclosing_class(node)
            qual = f"{cls.name}.{node.name}" if cls else node.name
            info = _FnInfo(node)
            for c in calls_in(node):
                seg = last_seg(dotted(c.func))
                if seg:
                    info.calls.add(seg)
            fns[qual] = info
            fns.setdefault(node.name, info)

    # direct acquisitions + per-with-body analysis
    edges: Set[Tuple[str, str, int]] = set()

    bound = _hot_lock_bindings(module)
    hot_keys: Set[str] = set()

    def with_lock_items(w: ast.With) -> List[str]:
        keys = []
        for item in w.items:
            key, hot = _port_lock_key(module, item.context_expr, bound)
            if key is not None:
                keys.append(key)
                if hot:
                    hot_keys.add(key)
        return keys

    for node in ast.walk(module.tree):
        if not isinstance(node, ast.With):
            continue
        keys = with_lock_items(node)
        if not keys:
            continue
        fn = module.enclosing_function(node)
        if fn is not None:
            cls = module.enclosing_class(node)
            qual = f"{cls.name}.{fn.name}" if cls else fn.name
            if qual in fns:
                fns[qual].locks.update(keys)
        # ordered acquisition within one `with a, b:` statement
        for a, b in zip(keys, keys[1:]):
            edges.add((a, b, node.lineno))
        held = keys[-1]
        hot = any(k in hot_keys for k in keys)
        for stmt in node.body:
            for inner in ast.walk(stmt):
                if isinstance(inner, ast.With):
                    for k in with_lock_items(inner):
                        for h in keys:
                            if k != h:
                                edges.add((h, k, inner.lineno))
                if not isinstance(inner, ast.Call):
                    continue
                name = dotted(inner.func)
                seg = last_seg(name)
                if seg is None:
                    continue
                blocking = seg in _BLOCKING_CALLS or (
                    name or ""
                ).startswith("subprocess.")
                if seg == "join" and isinstance(
                    inner.func, ast.Attribute
                ) and isinstance(inner.func.value, ast.Constant):
                    blocking = False  # "sep".join(...) is not a thread join
                if blocking:
                    out.append(Finding(
                        "CT003", module.path, inner.lineno, inner.col_offset,
                        f"blocking call '{name}' while holding lock "
                        f"'{held}': a stuck callee freezes every thread "
                        "contending for the lock — move the wait outside "
                        "the critical section",
                    ))
                elif hot and (seg in _HOT_BLOCKING or seg == "open"):
                    out.append(Finding(
                        "CT003", module.path, inner.lineno, inner.col_offset,
                        f"IO/serialization call '{name}' under hot lock "
                        f"'{held}' (XLA dispatch / chunk-cache LRU): this "
                        "serializes the whole sweep behind one filesystem "
                        "call — stage the data outside the lock",
                    ))
                # call to a local function that itself takes locks
                callee = fns.get(seg)
                if callee is not None:
                    for k in callee.locks:
                        for h in keys:
                            if k != h:
                                edges.add((h, k, inner.lineno))

    # cycle detection over the lock-order graph
    graph: Dict[str, Set[str]] = {}
    at_line: Dict[Tuple[str, str], int] = {}
    for a, b, line in edges:
        graph.setdefault(a, set()).add(b)
        at_line.setdefault((a, b), line)

    WHITE, GREY, BLACK = 0, 1, 2
    color = {k: WHITE for k in set(graph) | {v for vs in graph.values() for v in vs}}
    reported: Set[frozenset] = set()

    def visit(u: str, stack: List[str]) -> None:
        color[u] = GREY
        stack.append(u)
        for v in sorted(graph.get(u, ())):
            if color[v] == GREY:
                cycle = stack[stack.index(v):] + [v]
                key = frozenset(cycle)
                if key not in reported:
                    reported.add(key)
                    line = at_line.get((u, v), 1)
                    out.append(Finding(
                        "CT003", module.path, line, 0,
                        "lock-order cycle "
                        + " -> ".join(cycle)
                        + ": two threads taking these locks in opposite "
                        "orders deadlock; pick one global order",
                    ))
            elif color[v] == WHITE:
                visit(v, stack)
        stack.pop()
        color[u] = BLACK

    for u in sorted(color):
        if color[u] == WHITE:
            visit(u, [])
    return out


# =============================================================================
# CT004 - fault-site coverage
# =============================================================================

#: fallback registry (kept in sync with runtime/faults.py; the rule reads
#: the real module when it is reachable on disk)
_DEFAULT_SITES = frozenset({
    "load", "store", "io_read", "io_write", "submit", "task",
    "block_done", "task_done", "compute", "kernel", "admit",
    "journal", "journal_append", "journal_replay",
    "net_member", "net_probe", "net_client",
})
_DEFAULT_KINDS = frozenset({
    "error", "oom", "enospc", "hang", "corrupt", "nan",
    "job_loss", "kill", "preempt", "spill", "reject", "torn",
    "net_delay", "net_drop", "net_wedge",
})

#: hook callables whose first positional arg is a site name
_SITE_HOOKS = {
    "maybe_fail", "maybe_hang", "chunk_corrupt", "kill_point",
    "corrupt", "_inject", "_hang",
}

#: dataset IO boundary methods that must carry an injection hook
_BOUNDARY_METHODS = ("__getitem__", "__setitem__", "read_async", "write_async")


def _load_fault_registry(module: LintModule) -> Tuple[Set[str], Set[str]]:
    """(sites, kinds) parsed from the real ``runtime/faults.py`` when
    resolvable from ``module``'s location, else the pinned defaults."""
    root = _package_root(module.path)
    path = os.path.join(root, "runtime", "faults.py") if root else None
    if module.name == "faults.py":
        path = module.path
    registry = _from_file(path, _registry_of) if path else None
    if registry is None:
        return set(_DEFAULT_SITES), set(_DEFAULT_KINDS)
    return set(registry[0]), set(registry[1])


def _registry_of(tree: ast.AST) -> Tuple[frozenset, frozenset]:
    sites: Set[str] = set()
    kinds: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if not targets:
                continue
            name = targets[0]
            if name.endswith("_SITES") and isinstance(node.value, ast.Tuple):
                for el in node.value.elts:
                    s = str_const(el)
                    if s:
                        sites.add(s)
            if name == "_FAIL_KINDS" and isinstance(node.value, ast.Tuple):
                for el in node.value.elts:
                    s = str_const(el)
                    if s:
                        kinds.add(s)
        # kind literals in the validation chain:  kind == "nan"  /
        # kind in ("kill", "preempt")
        if isinstance(node, ast.Compare):
            left = dotted(node.left)
            if last_seg(left) != "kind":
                continue
            for comp in node.comparators:
                s = str_const(comp)
                if s:
                    kinds.add(s)
                if isinstance(comp, (ast.Tuple, ast.List)):
                    for el in comp.elts:
                        s = str_const(el)
                        if s:
                            kinds.add(s)
    sites |= {"kernel", "compute"}  # corrupt-hook + executor compute site
    return frozenset(sites or _DEFAULT_SITES), frozenset(kinds or _DEFAULT_KINDS)


def ct004_fault_site_coverage(module: LintModule) -> List[Finding]:
    """Every IO/compute boundary carries a fault hook; site names and the
    fault-class registry stay consistent.

    The chaos suite only proves what the hooks reach: a Dataset method
    without ``_inject``/``_hang`` is a storage boundary chaos cannot
    exercise, a typo'd site string is a hook that never fires, and a
    shrunken fault-kind registry silently un-tests recovery paths.
    """
    is_fixture = "ct004" in module.name
    sites, kinds = _load_fault_registry(module)
    out: List[Finding] = []

    # (a) site-name vocabulary at every hook call
    for call in calls_in(module.tree):
        seg = last_seg(dotted(call.func))
        if seg not in _SITE_HOOKS or not call.args:
            continue
        site = str_const(call.args[0])
        if site is not None and site not in sites:
            out.append(Finding(
                "CT004", module.path, call.lineno, call.col_offset,
                f"unknown fault site {site!r} passed to {seg} (registry: "
                f"{sorted(sites)}): this hook can never fire — typo, or "
                "register the site in runtime/faults.py",
            ))

    # (b) dataset boundary coverage (container layer + fixtures)
    if module.name == "containers.py" or is_fixture:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef) or "Dataset" not in node.name:
                continue
            for item in node.body:
                if not isinstance(item, ast.FunctionDef):
                    continue
                if item.name not in _BOUNDARY_METHODS:
                    continue
                hooked = any(
                    last_seg(dotted(c.func)) in ("_inject", "maybe_fail")
                    for c in calls_in(item)
                )
                if not hooked:
                    out.append(Finding(
                        "CT004", module.path, item.lineno, item.col_offset,
                        f"storage boundary {node.name}.{item.name} has no "
                        "fault-injection hook (_inject/maybe_fail): chaos "
                        "tests cannot exercise failures at this IO path",
                    ))

    # (c) executor compute/load/store coverage
    if module.name == "executor.py" and "lint_fixtures" not in module.path:
        seen_sites: Set[str] = set()
        kill_sites: Set[str] = set()
        for call in calls_in(module.tree):
            seg = last_seg(dotted(call.func))
            if seg in ("maybe_fail", "maybe_hang") and call.args:
                s = str_const(call.args[0])
                if s:
                    seen_sites.add(s)
            if seg == "kill_point" and call.args:
                s = str_const(call.args[0])
                if s:
                    kill_sites.add(s)
        for required in ("load", "store", "compute"):
            if required not in seen_sites:
                out.append(Finding(
                    "CT004", module.path, 1, 0,
                    f"executor no longer injects faults at site "
                    f"{required!r}: the {required} boundary is chaos-blind",
                ))
        if "block_done" not in kill_sites:
            out.append(Finding(
                "CT004", module.path, 1, 0,
                "executor lost its kill_point('block_done') crossing: "
                "preemption chaos cannot target block completion",
            ))

    # (d) the 12-class registry itself
    if module.name == "faults.py" and "lint_fixtures" not in module.path:
        missing = _DEFAULT_KINDS - kinds
        if missing:
            out.append(Finding(
                "CT004", module.path, 1, 0,
                f"fault-class registry lost kind(s) {sorted(missing)} "
                f"(now: {sorted(kinds)}): recovery paths for them are "
                "untestable",
            ))
    return out


# =============================================================================
# CT005 - device-work hygiene
# =============================================================================

#: the hand-kernel entries of ``ops/kernels.py``: its public functions that
#: launch a CUDA kernel (call ``_launch``).  Pinned here for files outside
#: the package (``chip_smoke.py``, ``scripts/``); read from the real module
#: when the checked file lies in the package.
_DEFAULT_KERNEL_ENTRIES = frozenset({
    "tile_ccl", "tile_ws_propagate", "edt_cascade", "apply_remap",
})

#: clock reads that start or end a timing
_CT005_CLOCKS = frozenset({
    "time.perf_counter", "time.perf_counter_ns", "time.monotonic",
    "time.monotonic_ns", "time.time", "time.time_ns",
})

#: source evidence that the host waited for the card before reading the
#: clock (``torch.cuda.synchronize``, ``stream.synchronize()``,
#: ``event.synchronize()``, a CUDA event's ``elapsed_time``, or a copy of
#: a result to the host)
_CT005_SYNC_MARKERS = (".synchronize(", "elapsed_time", ".item(", ".cpu(",
                       ".tolist(")

#: draws from torch's global generator unless given ``generator=``
_CT005_TORCH_DRAWS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
})
#: in-place tensor draws from the global generator unless given one
_CT005_TENSOR_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})
#: reseeding the global generators: never per shard
_CT005_RESEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
})
#: ``np.random`` names that make a generator of their own (not the legacy
#: global state)
_CT005_NP_OWN = frozenset({
    "default_rng", "Generator", "RandomState", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "MT19937", "Philox", "SFC64",
})


def _kernel_entries(module: LintModule) -> Set[str]:
    """The hand-kernel entry names: the public functions of the port's
    ``ops/kernels.py`` that call ``_launch``, read when the checked file
    lies in the package, else :data:`_DEFAULT_KERNEL_ENTRIES`."""
    root = _package_root(module.path)
    path = os.path.join(root, "ops", "kernels.py") if root else None
    entries = _from_file(path, _entries_of) if path else None
    return set(entries or _DEFAULT_KERNEL_ENTRIES)


def _entries_of(tree: ast.AST) -> frozenset:
    return frozenset(
        node.name for node in tree.body
        if isinstance(node, ast.FunctionDef)
        and not node.name.startswith("_")
        and any(last_seg(dotted(c.func)) == "_launch" for c in calls_in(node))
    )


def _shard_bodies(defs: Dict[str, ast.AST],
                  shard_maps: List[ast.Call]) -> Dict[str, ast.AST]:
    """Every function passed to ``shard_map`` (by name, through
    ``functools.partial``, or as a lambda, keyed ``<lambda:LINE>``)."""
    bodies: Dict[str, ast.AST] = {}
    for call in shard_maps:
        arg = call.args[0]
        while isinstance(arg, ast.Call) \
                and last_seg(dotted(arg.func)) == "partial" and arg.args:
            arg = arg.args[0]
        if isinstance(arg, ast.Lambda):
            bodies[f"<lambda:{arg.lineno}>"] = arg
        elif isinstance(arg, ast.Name) and arg.id in defs:
            bodies[arg.id] = defs[arg.id]
    return bodies


def _global_draw(call: ast.Call) -> Optional[str]:
    """The dotted name of ``call`` when it draws from (or reseeds) a
    process-global random generator, else None."""
    kws, splat = kw_names(call)
    own_generator = "generator" in kws or splat
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _CT005_TENSOR_DRAWS:
        return None if own_generator else (
            dotted(call.func) or f"<tensor>.{call.func.attr}")
    name = dotted(call.func)
    if name is None:
        return None
    if name in _CT005_RESEEDS:
        return name
    if name in _CT005_TORCH_DRAWS:
        return None if own_generator else name
    for prefix in ("np.random.", "numpy.random."):
        if name.startswith(prefix) and name.count(".") == prefix.count("."):
            return None if last_seg(name) in _CT005_NP_OWN else name
    if name.startswith("random.") and name.count(".") == 1:
        return None if name == "random.Random" else name
    return None


def ct005_device_hygiene(module: LintModule) -> List[Finding]:
    """Device work must be timed with a synchronization, and per-shard
    bodies must not draw from a global random generator.

    The reference's CT005 (jit hygiene) guards traced code.  Nothing is
    traced or compiled in the port, so the rule keeps its id and checks
    the port's referents of its clauses:

    (a) **Timing device work without synchronization** (the reference's
    last clause): CUDA launches are asynchronous, as jax dispatch is, so
    a function that reads the clock twice and calls a hand-kernel entry
    of ``ops/kernels.py`` (a public function there that launches a
    kernel), a body passed to ``parallel/spmd.py::shard_map``, or the
    callable ``shard_map`` returned, must show a synchronization marker —
    ``torch.cuda.synchronize``, ``.synchronize(``, ``elapsed_time``,
    ``.item(``, ``.cpu(`` or ``.tolist(`` — in its own source or in a
    same-module helper it calls; else it measures the launch, not the
    work.

    (b) **Global randomness in per-shard bodies** (the port's form of the
    reference's impurity clause): ``spmd.shard_map`` runs its body on one
    thread a shard, so a draw from the process-global generator
    (``torch.rand*``/``randn``/``randint``/``randperm``/... or an
    in-place ``tensor.uniform_()``-style draw without ``generator=``,
    ``torch.manual_seed``, the legacy ``np.random.<fn>`` calls,
    ``random.<fn>``) happens in a different order on every run, and so
    does the result.  A generator of the body's own
    (``torch.Generator``, ``np.random.default_rng(seed)``,
    ``random.Random(seed)``) is fine.

    Dropped: the reference's traced-value branch clause and its
    unhashable-static-argument clause (nothing is traced, so a Python
    branch on a tensor is an ordinary host read and there are no static
    arguments), and the rest of its impurity clause (a side effect or a
    clock read in a shard body runs on every call, not once at trace
    time).
    """
    out: List[Finding] = []
    # one walk: the module's functions, its shard_map calls and the names
    # bound to their results, its clock reads and its kernel imports
    defs: Dict[str, ast.AST] = {}
    shard_maps: List[ast.Call] = []
    callables: Set[str] = set()
    clock_reads: List[ast.Call] = []
    imported: Dict[str, str] = {}  # local name -> name in a kernels module
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
        elif isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            if name in _CT005_CLOCKS:
                clock_reads.append(node)
            elif last_seg(name) == "shard_map" and node.args:
                shard_maps.append(node)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and last_seg(dotted(node.value.func)) == "shard_map":
            callables |= {dotted(t) for t in node.targets} - {None}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.module.rsplit(".", 1)[-1] == "kernels":
            imported.update((a.asname or a.name, a.name) for a in node.names)
    bodies = _shard_bodies(defs, shard_maps)

    # -- (b) no global randomness in a per-shard body ----------------------
    for name, body in sorted(bodies.items()):
        for call in calls_in(body):
            draw = _global_draw(call)
            if draw is None:
                continue
            out.append(Finding(
                "CT005", module.path, call.lineno, call.col_offset,
                f"global random generator '{draw}' inside per-shard body "
                f"'{name}': spmd.shard_map runs one thread a shard, so the "
                "shards draw in a different order on every run and the "
                "result is not reproducible — give the body its own "
                "torch.Generator (generator=) or np.random.default_rng(seed)",
            ))

    # -- (a) no timing of device work without a synchronization ------------
    # each function's clock reads, its nested functions' included (one
    # walk up from every clock read instead of a walk down every function)
    clocks: Dict[ast.AST, List[ast.Call]] = {}
    for call in clock_reads:
        fn = module.enclosing_function(call)
        while fn is not None:
            clocks.setdefault(fn, []).append(call)
            fn = module.enclosing_function(fn)
    timed = [
        (fn, min(reads, key=lambda c: (c.lineno, c.col_offset)))
        for fn, reads in clocks.items() if len(reads) >= 2
    ]
    if not timed:
        return out
    entries = _kernel_entries(module)
    kernel_imports = {k for k, v in imported.items() if v in entries}
    if module.name == "kernels.py":
        kernel_imports |= entries

    def source_of(node: ast.AST) -> str:
        try:
            return ast.get_source_segment(module.source, node) or ""
        except Exception:  # pragma: no cover - malformed coords
            return ""

    def syncs(node: ast.AST) -> bool:
        if any(m in source_of(node) for m in _CT005_SYNC_MARKERS):
            return True
        # one level into same-module helpers (``_sync(device)``)
        for c in calls_in(node):
            callee = defs.get(last_seg(dotted(c.func)) or "")
            if callee is not None and callee is not node and any(
                m in source_of(callee) for m in _CT005_SYNC_MARKERS
            ):
                return True
        return False

    def device_work(call: ast.Call) -> Optional[str]:
        if isinstance(call.func, ast.Call) \
                and last_seg(dotted(call.func.func)) == "shard_map":
            return "a shard_map call"
        name = dotted(call.func)
        if name is None:
            return None
        if isinstance(call.func, ast.Attribute) and call.func.attr in entries:
            return f"hand kernel '{name}'"
        if isinstance(call.func, ast.Name) and name in kernel_imports:
            return f"hand kernel '{name}'"
        if name in callables:
            return f"shard_map callable '{name}'"
        if isinstance(call.func, ast.Name) and name in bodies:
            return f"per-shard body '{name}'"
        return None

    for node, clock in timed:
        work = next(
            (w for w in (device_work(c) for c in calls_in(node)) if w), None
        )
        if work is None or syncs(node):
            continue
        out.append(Finding(
            "CT005", module.path, clock.lineno, clock.col_offset,
            f"'{node.name}' times {work} without synchronization (CUDA "
            "launches are async): call torch.cuda.synchronize (or fetch a "
            "result with .item()/.cpu()) before reading the clock",
        ))
    return out


# =============================================================================
# CT006 - drain safety
# =============================================================================


def _handler_catches_base(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    names: List[Optional[str]] = []
    if isinstance(handler.type, ast.Tuple):
        names = [last_seg(dotted(el)) for el in handler.type.elts]
    else:
        names = [last_seg(dotted(handler.type))]
    return any(n in ("BaseException", "KeyboardInterrupt") for n in names)


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    """Only an actual ``raise`` statement counts — a handler that merely
    *inspects* DrainInterrupt (``if isinstance(e, DrainInterrupt): log()``)
    still swallows the drain."""
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def ct006_drain_safety(module: LintModule) -> List[Finding]:
    """Preemption drains must reach the exit code, never a retry loop.

    ``DrainInterrupt`` is a ``BaseException`` precisely so broad ``except
    Exception`` recovery paths cannot swallow a preemption — but a bare
    ``except:`` / ``except BaseException:`` without a re-raise still can,
    ``os._exit`` outside the fault injector skips every flush the drain
    protocol relies on, and an entry point that builds a task DAG without
    mapping ``DrainInterrupt`` to ``REQUEUE_EXIT_CODE`` turns a graceful
    eviction into a crash the scheduler won't requeue.
    """
    out: List[Finding] = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ExceptHandler):
            if _handler_catches_base(node) and not _handler_reraises(node):
                what = (
                    "bare 'except:'" if node.type is None
                    else "'except BaseException'"
                )
                out.append(Finding(
                    "CT006", module.path, node.lineno, node.col_offset,
                    f"{what} swallows DrainInterrupt (a BaseException): a "
                    "preemption drain dies here instead of reaching the "
                    "requeue exit — catch Exception, or re-raise "
                    "BaseException/DrainInterrupt",
                ))
        if isinstance(node, ast.Call):
            if dotted(node.func) == "os._exit" and module.name != "faults.py":
                out.append(Finding(
                    "CT006", module.path, node.lineno, node.col_offset,
                    "os._exit outside runtime/faults.py: skips marker/"
                    "manifest flushes and the drain protocol — raise, or "
                    "sys.exit through the entry point",
                ))

    # entry-point contract: __main__ + build() must speak the drain protocol
    has_main_guard = any(
        isinstance(n, ast.If)
        and isinstance(n.test, ast.Compare)
        and isinstance(n.test.left, ast.Name)
        and n.test.left.id == "__name__"
        for n in ast.walk(module.tree)
    )
    if has_main_guard:
        build_calls = [
            c for c in calls_in(module.tree)
            if isinstance(c.func, ast.Name) and c.func.id == "build"
        ]
        if build_calls and not (
            "DrainInterrupt" in module.source
            and "REQUEUE_EXIT_CODE" in module.source
        ):
            c = build_calls[0]
            out.append(Finding(
                "CT006", module.path, c.lineno, c.col_offset,
                "entry point runs a task DAG but never maps DrainInterrupt "
                "to REQUEUE_EXIT_CODE: a SIGTERM mid-run exits as a crash "
                "instead of a scheduler requeue — wrap the build in "
                "'except DrainInterrupt: sys.exit(REQUEUE_EXIT_CODE)'",
            ))
    return out


# =============================================================================
# CT007 - memory-target spill contract
# =============================================================================

#: creation kwargs a handoff_dataset declaration must carry so the storage
#: spill twin can be created (positionally: path, key, shape, chunks, dtype)
_CT007_CREATE_KWS = ("shape", "chunks", "dtype")

#: kwargs a device-rung publish must carry (positionally: path, arrays,
#: producer, failures_path): without them the demote-to-host / host-staged
#: fallback cannot be attributed (``degraded:host_staged`` in failures.json)
#: and the device handoff's spill contract is silently broken.
_CT007_DEVICE_PUBLISH_KWS = ("producer", "failures_path")


def ct007_memory_target_contract(module: LintModule) -> List[Finding]:
    """A task that declares a ``MemoryTarget`` output must wire the spill
    path (docs/PERFORMANCE.md "Task-graph fusion").

    An in-memory handoff is only safe because spill-to-storage is the
    universal fallback: every ``handoff_dataset`` declaration must pass the
    full storage wiring (``path``/``key`` plus ``shape``/``chunks``/
    ``dtype``, or the spill twin cannot be created when admission, headroom
    pressure, or a forced ``spill`` fault demands it), and the returned
    handle must be wired into a post-store ``region_verifier`` somewhere in
    the module so integrity verification covers the in-memory data plane —
    a handoff without a verifier is a storage boundary the post-store
    corruption defense cannot see.

    Device-rung declarations (``publish_device_arrays``) carry the same
    obligation one rung up: every publish must wire ``producer`` +
    ``failures_path`` so a demotion or host-staged fallback stays
    attributable (``degraded:host_staged``) instead of silently vanishing
    from the failure ledger.
    """
    if module.name in ("task.py", "handoff.py") \
            and "lint_fixtures" not in module.path:
        return []  # the defining surface, not a call site
    out: List[Finding] = []
    verified: Set[str] = set()
    for call in calls_in(module.tree):
        if last_seg(dotted(call.func)) == "region_verifier" and call.args:
            name = dotted(call.args[0])
            if name:
                verified.add(last_seg(name))

    def _check(call: ast.Call, bound: Optional[str]) -> None:
        present, splat = kw_names(call)
        if splat:
            return  # wiring forwarded wholesale; not statically checkable
        pos = len(call.args)
        missing = []
        # positional args fill path then key (in that order); either may
        # equally come as a keyword — a positional path + key= kwarg is
        # fully wired
        if pos == 0 and not {"path", "key"} <= present:
            missing.append("path/key")
        elif pos == 1 and "key" not in present:
            missing.append("key")
        need = max(0, 5 - pos)
        if need:
            # with pos < 2 the path/key slots are also unfilled; the slice
            # start clamps at 0 so ALL creation kwargs stay required
            # (a negative start would wrap and silently drop 'shape')
            start = max(0, len(_CT007_CREATE_KWS) - need)
            missing += [
                k for k in _CT007_CREATE_KWS[start:]
                if k not in present
            ]
        if missing:
            out.append(Finding(
                "CT007", module.path, call.lineno, call.col_offset,
                f"handoff_dataset declaration misses spill wiring "
                f"{missing}: without the full storage twin spec the "
                "MemoryTarget cannot spill under admission/headroom/fault "
                "pressure and the fallback contract is broken",
            ))
        if bound is None:
            out.append(Finding(
                "CT007", module.path, call.lineno, call.col_offset,
                "handoff_dataset result is not bound to a name: the handle "
                "cannot be wired into a region_verifier, so the in-memory "
                "data plane is invisible to integrity verification",
            ))
        elif bound not in verified:
            out.append(Finding(
                "CT007", module.path, call.lineno, call.col_offset,
                f"handoff handle {bound!r} is never passed to "
                "region_verifier(...) in this module: wire "
                "store_verify_fn=region_verifier(...) so post-store "
                "integrity checks cover the in-memory target too",
            ))

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign):
            call = node.value
            if isinstance(call, ast.Call) \
                    and last_seg(dotted(call.func)) == "handoff_dataset":
                bound = None
                if len(node.targets) == 1 and isinstance(
                    node.targets[0], ast.Name
                ):
                    bound = node.targets[0].id
                _check(call, bound)
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if last_seg(dotted(call.func)) == "handoff_dataset":
                _check(call, None)

    for call in calls_in(module.tree):
        if last_seg(dotted(call.func)) != "publish_device_arrays":
            continue
        present, splat = kw_names(call)
        if splat:
            continue  # wiring forwarded wholesale; not statically checkable
        pos = len(call.args)
        # positional args fill path, arrays, producer, failures_path
        missing = [
            k for i, k in enumerate(_CT007_DEVICE_PUBLISH_KWS)
            if pos < 3 + i and k not in present
        ]
        if missing:
            out.append(Finding(
                "CT007", module.path, call.lineno, call.col_offset,
                f"device handoff publish misses its spill contract "
                f"{missing}: a demotion or host-staged fallback from the "
                "device rung cannot be attributed (degraded:host_staged "
                "in failures.json) without the producer identity and the "
                "failure-ledger path",
            ))
    return out


# =============================================================================
# CT008 - trace hygiene
# =============================================================================

#: direct wall-clock calls banned in ``runtime/`` outside the tracer
#: (docs/OBSERVABILITY.md "Timing discipline"): every duration must come
#: from a trace span (so the timeline, the counters, and the manifests
#: agree on one clock) and every wall timestamp from ``trace.walltime()``.
_CT008_BANNED_CLOCKS = frozenset({"time.time", "time.perf_counter"})

#: orchestration entry points that must run under a task trace context —
#: the spans they emit (executor.load/store/dispatch, host.block,
#: solve.*) are only attributable when a ``task.run``-shaped span
#: brackets them.  Call sites inside a class get the context from
#: ``BaseTask.run``; free functions (benchmarks, scripts) must open
#: one explicitly with ``trace.task_context(...)``.
_CT008_TRACED_CALLS = frozenset({
    "map_blocks",
    "host_block_map",
    "solve_with_reduce_tree",
})


def _in_runtime_package(path: str) -> bool:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    try:
        return parts[parts.index(PACKAGE) + 1] == "runtime"
    except (ValueError, IndexError):
        return False


def ct008_trace_hygiene(module: LintModule) -> List[Finding]:
    """The unified tracing plane's two contracts (docs/OBSERVABILITY.md).

    (a) **One clock**: no direct ``time.time()`` / ``time.perf_counter()``
    timing in ``runtime/`` outside ``trace.py`` — durations come from
    trace spans (``trace.span``/``trace.begin``, whose ``end()`` returns
    the elapsed seconds even with the tracer off) and wall timestamps
    from ``trace.walltime()``, so the timeline, the io_metrics counters,
    and the heartbeat/manifest stamps can never disagree about where the
    wall-clock went.  ``time.monotonic()`` deadlines and ``time.sleep``
    backoffs are not timing *measurements* and stay allowed.

    (b) **Attributable spans**: every ``map_blocks`` /
    ``host_block_map`` / ``solve_with_reduce_tree`` call site runs under
    a task trace context — inside a task class (``BaseTask.run`` opens
    the ``task.run`` span) or under an explicit
    ``trace.task_context(...)`` in the enclosing function/module (benchmarks,
    scripts).  Without it, the hot-boundary spans those calls
    emit land on the timeline with no task to belong to.
    """
    out: List[Finding] = []
    is_fixture = "ct008" in module.name

    # -- (a) wall-clock discipline in runtime/ ----------------------------
    if (is_fixture or _in_runtime_package(module.path)) \
            and module.name != "trace.py":
        time_aliases = {"time"}   # names that refer to the time module
        from_time = {}            # local name -> original name in time
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_aliases.add(a.asname or a.name)
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    from_time[a.asname or a.name] = a.name
        for call in calls_in(module.tree):
            name = dotted(call.func)
            if name is None:
                continue
            mod, _, attr = name.rpartition(".")
            banned = (
                name in _CT008_BANNED_CLOCKS
                # aliased module form: import time as t; t.perf_counter()
                or (mod in time_aliases
                    and attr in ("time", "perf_counter"))
                # from-import form incl. aliases: from time import
                # perf_counter as pc; pc()
                or from_time.get(name) in ("time", "perf_counter")
            )
            if banned:
                out.append(Finding(
                    "CT008", module.path, call.lineno, call.col_offset,
                    f"direct {name}() timing in runtime/ bypasses the "
                    "tracing plane; measure durations with trace.span/"
                    "trace.begin (end() returns elapsed seconds even with "
                    "the tracer off) and stamp wall clocks with "
                    "trace.walltime()",
                ))

    # -- (b) orchestration calls under a task trace context ---------------
    for call in calls_in(module.tree):
        seg = last_seg(dotted(call.func))
        if seg not in _CT008_TRACED_CALLS:
            continue
        if module.enclosing_class(call) is not None:
            # a method of a task class: BaseTask.run brackets run_impl
            # (and everything it calls) in the task.run span
            continue
        covered = False
        scope: Optional[ast.AST] = module.enclosing_function(call)
        while scope is not None and not covered:
            covered = any(
                last_seg(dotted(c.func)) == "task_context"
                for c in calls_in(scope)
            )
            scope = module.enclosing_function(scope)
        if not covered:
            # module level: a top-level task_context call still counts
            covered = any(
                last_seg(dotted(c.func)) == "task_context"
                and module.enclosing_function(c) is None
                for c in calls_in(module.tree)
            )
        if not covered:
            out.append(Finding(
                "CT008", module.path, call.lineno, call.col_offset,
                f"{seg} call site outside any task class and without a "
                "trace.task_context(...) in scope: its hot-boundary spans "
                "would land on the timeline unattributed — open a task "
                "context (or move the call into a task)",
            ))
    return out


# =============================================================================
# CT009 - service-mode server hygiene
# =============================================================================

#: the service-mode surface (docs/SERVING.md): the resident server, its
#: admission controller, and the serve CLI entry
_CT009_SCOPE = ("server.py", "admission.py", "serve.py")

#: storage-IO call segments additionally banned under the server's
#: bookkeeping locks: every request handler, HTTP thread, and worker
#: contends for the admission/request locks, so one filesystem call under
#: them head-of-line-blocks the whole service
_CT009_IO_CALLS = frozenset({
    "open", "dump", "dumps", "load", "loads", "listdir", "replace",
    "unlink", "remove", "makedirs", "save", "fsync", "read", "write",
    "atomic_write_json", "record_failures", "dump_config", "_write_state",
    "flush_namespace", "_json_report",
})


def _walk_inline(stmt: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` minus nested function/lambda bodies: a def or lambda
    under a lock only DEFINES deferred code — what it calls runs after the
    lock is released, so flagging it would be a false positive."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def ct009_server_hygiene(module: LintModule) -> List[Finding]:
    """Service-mode hygiene for the resident server (docs/SERVING.md).

    (a) **Admission-lock discipline**: the admission/request locks guard
    pure bookkeeping only — no blocking calls (``.result``/``sleep``/
    ``wait``/``join``) and no storage IO (``open``/``json.dump``/
    ``atomic_write_json``/``record_failures``/...) while holding them.
    Every submit, worker dispatch, and status probe contends for these
    locks; one slow callee under them freezes the whole service.

    (b) **Attributable request handlers**: every handler that runs a
    workflow (``build(...)``) must do so under BOTH an ambient request
    context (``admission.request_context``/``request_scope`` — handoff
    identities lose their request namespace without it, letting
    concurrent requests over the same paths resolve each other's
    intermediates) and a trace task context (``trace.task_context`` —
    otherwise the request's spans land on the resident timeline with no
    request to belong to).

    (c) **Drain protocol at the entry point**: any caller of
    ``serve_until_drained()`` (which raises ``DrainInterrupt`` after the
    drain finishes) must map it to ``REQUEUE_EXIT_CODE`` — a drained
    server that exits nonzero-as-crash breaks the rolling-restart
    protocol (docs/SERVING.md "Lifecycle").
    """
    is_fixture = "ct009" in module.name
    if module.name not in _CT009_SCOPE and not is_fixture:
        return []
    out: List[Finding] = []

    # -- (a) nothing slow under the server's bookkeeping locks -------------
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.With):
            continue
        keys = [
            k for k in (
                _lock_key(module, item.context_expr) for item in node.items
            ) if k is not None
        ]
        if not keys:
            continue
        held = keys[-1]
        for stmt in node.body:
            for inner in _walk_inline(stmt):
                if not isinstance(inner, ast.Call):
                    continue
                name = dotted(inner.func)
                seg = last_seg(name)
                if seg is None:
                    continue
                if seg in _BLOCKING_CALLS or (name or "").startswith(
                    "subprocess."
                ):
                    if seg == "join" and isinstance(
                        inner.func, ast.Attribute
                    ) and isinstance(inner.func.value, ast.Constant):
                        continue  # "sep".join(...) is not a thread join
                    out.append(Finding(
                        "CT009", module.path, inner.lineno,
                        inner.col_offset,
                        f"blocking call '{name}' while holding server "
                        f"lock '{held}': every submit/dispatch/status "
                        "thread contends for it — wait outside the "
                        "critical section (admission waits on the "
                        "dispatch event, not under the lock)",
                    ))
                elif seg in _CT009_IO_CALLS:
                    out.append(Finding(
                        "CT009", module.path, inner.lineno,
                        inner.col_offset,
                        f"storage IO '{name}' under server lock "
                        f"'{held}': state/failure writes must happen "
                        "after release — snapshot under the lock, write "
                        "outside it",
                    ))

    # -- (b) request handlers run under request + trace contexts -----------
    for call in calls_in(module.tree):
        if last_seg(dotted(call.func)) != "build":
            continue
        covered_req = covered_task = False
        scope: Optional[ast.AST] = module.enclosing_function(call)
        while scope is not None:
            for c in calls_in(scope):
                seg = last_seg(dotted(c.func))
                if seg in ("request_context", "request_scope"):
                    covered_req = True
                elif seg == "task_context":
                    covered_task = True
            scope = module.enclosing_function(scope)
        missing = []
        if not covered_req:
            missing.append("admission.request_context (handoff "
                           "identities lose their request namespace)")
        if not covered_task:
            missing.append("trace.task_context (spans land on the "
                           "resident timeline unattributed)")
        if missing:
            out.append(Finding(
                "CT009", module.path, call.lineno, call.col_offset,
                "request handler runs build() without "
                + " or ".join(missing),
            ))

    # -- (c) serve entry points speak the drain protocol -------------------
    for call in calls_in(module.tree):
        if last_seg(dotted(call.func)) != "serve_until_drained":
            continue
        if not ("DrainInterrupt" in module.source
                and "REQUEUE_EXIT_CODE" in module.source):
            out.append(Finding(
                "CT009", module.path, call.lineno, call.col_offset,
                "serve_until_drained() raises DrainInterrupt after the "
                "drain, but this entry point never maps it to "
                "REQUEUE_EXIT_CODE: a SIGTERM'd server exits as a crash "
                "instead of a rolling-restart requeue",
            ))
    return out


# =============================================================================
# CT010 - durable-journal discipline
# =============================================================================

#: the journal-aware surface (docs/SERVING.md "Durability"): the journal
#: itself plus everything that may hold the server's bookkeeping locks
_CT010_SCOPE = ("journal.py", "server.py", "admission.py", "serve.py")

#: IO methods that, invoked on a journal-named object/path outside
#: journal.py, bypass the one framed+fsync'd append path
_CT010_RAW_IO = frozenset({"write", "writelines", "truncate"})

#: journal-object call segments that do disk IO (an append is an fsync —
#: a disk round trip) and must never run under the server's locks
_CT010_JOURNAL_IO = frozenset({
    "append", "append_transition", "recover", "close", "_journal_append",
})


def _names_journal(name: Optional[str]) -> bool:
    return name is not None and "journal" in name.lower()


def ct010_journal_discipline(module: LintModule) -> List[Finding]:
    """The durable submission journal's three invariants
    (docs/SERVING.md "Durability").

    (a) **One append path**: outside ``runtime/journal.py``, nothing may
    write the journal file directly — no ``open()`` of a journal-named
    path in write/append mode, no ``.write``/``.truncate`` on a
    journal-named handle.  ``Journal.append`` is where the CRC framing
    and the fsync live; a raw write bypasses both and can forge a record
    a replay would trust.

    (b) **Fsync evidence**: the ``append`` method of a ``Journal`` class
    must call ``os.fsync`` — an acknowledgement whose record only made it
    to the page cache is a durability lie under SIGKILL.

    (c) **No journal IO under the server's locks**: a journal append is a
    disk round trip; under the admission/request locks it head-of-line
    blocks every submit, dispatch, and status thread (same reasoning as
    CT009's IO ban, extended to the journal object).
    """
    is_fixture = "ct010" in module.name
    if module.name not in _CT010_SCOPE and not is_fixture:
        return []
    out: List[Finding] = []
    is_journal_module = module.name == "journal.py" and not is_fixture

    # -- (a) raw journal-file IO outside the journal module ----------------
    if not is_journal_module:
        for call in calls_in(module.tree):
            name = dotted(call.func)
            seg = last_seg(name)
            if seg == "open" or name == "os.open":
                touches = any(
                    _names_journal(dotted(a)) or _names_journal(str_const(a))
                    for a in call.args
                )
                # read-mode opens are fine (report tooling scans the
                # journal); only write/append modes forge records.  A
                # mode-less builtin open() defaults to 'r' — read-only;
                # os.open takes flag ints we cannot prove read-only, so
                # it always counts as writable.
                mode = None
                if len(call.args) >= 2:
                    mode = str_const(call.args[1])
                for kw in call.keywords:
                    if kw.arg == "mode":
                        mode = str_const(kw.value)
                if name == "os.open":
                    writable = True
                else:
                    writable = mode is not None and any(
                        c in mode for c in ("w", "a", "+", "x")
                    )
                if touches and writable:
                    out.append(Finding(
                        "CT010", module.path, call.lineno, call.col_offset,
                        "raw open of the journal file outside "
                        "runtime/journal.py: appends must go through "
                        "Journal.append (CRC framing + fsync) — a direct "
                        "write can forge a record replay would trust",
                    ))
            elif seg in _CT010_RAW_IO and isinstance(
                call.func, ast.Attribute
            ):
                base = dotted(call.func.value)
                if _names_journal(base):
                    out.append(Finding(
                        "CT010", module.path, call.lineno, call.col_offset,
                        f"raw '{seg}' on journal handle '{base}' outside "
                        "runtime/journal.py: the one append path is "
                        "Journal.append (CRC framing + fsync)",
                    ))

    # -- (b) fsync evidence in the append path -----------------------------
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ClassDef) or "Journal" not in node.name:
            continue
        for item in node.body:
            if not isinstance(item, ast.FunctionDef) or item.name != "append":
                continue
            has_fsync = any(
                last_seg(dotted(c.func)) == "fsync" for c in calls_in(item)
            )
            if not has_fsync:
                out.append(Finding(
                    "CT010", module.path, item.lineno, item.col_offset,
                    f"{node.name}.append has no os.fsync evidence: an "
                    "acknowledgement whose record only reached the page "
                    "cache is a durability lie under SIGKILL — fsync "
                    "before returning",
                ))

    # -- (c) no journal IO under the server's bookkeeping locks ------------
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.With):
            continue
        keys = [
            k for k in (
                _lock_key(module, item.context_expr) for item in node.items
            ) if k is not None
        ]
        if not keys:
            continue
        held = keys[-1]
        if is_journal_module and held == "Journal._lock":
            continue  # the journal's own lock IS the append serializer
        for stmt in node.body:
            for inner in _walk_inline(stmt):
                if not isinstance(inner, ast.Call):
                    continue
                name = dotted(inner.func)
                seg = last_seg(name)
                if seg in _CT010_JOURNAL_IO and _names_journal(name):
                    out.append(Finding(
                        "CT010", module.path, inner.lineno,
                        inner.col_offset,
                        f"journal IO '{name}' while holding server lock "
                        f"'{held}': an append is an fsync — a disk round "
                        "trip that head-of-line blocks every "
                        "submit/dispatch/status thread; journal outside "
                        "the critical section",
                    ))
    return out


# =============================================================================
# CT011 - verified-read discipline
# =============================================================================

#: the verifying reader lives in the io package (docs/SERVING.md
#: "Self-healing"); inside it, raw reads are the implementation
_CT011_IO_PKG = os.path.join(PACKAGE, "io") + os.sep

#: sidecar directories whose raw traversal outside io/ bypasses the
#: dataset API (scrub/repair must use checksum_regions / verify_region)
_CT011_SIDECAR_DIRS = (".ctt_checksums",)

#: file-read entry points checked for sidecar-path constants
_CT011_OPENERS = frozenset({"open", "fromfile", "memmap", "load"})


def _ct011_outside_io(path: str) -> bool:
    return _CT011_IO_PKG not in os.path.abspath(path)


def ct011_verified_read_discipline(module: LintModule) -> List[Finding]:
    """Every read of a block product goes through the verifying reader
    (docs/SERVING.md "Self-healing").  The container read paths
    (``ds[bb]`` / ``read_async``) ARE the verifying reader — digest
    verification, the missing-sidecar policy, and lineage repair ride
    them — so outside ``cluster_tools_tpu_torch/io/`` nothing may:

    (a) call ``_read_back`` (the raw, verification-free region read);
    (b) read through a dataset's raw ``._store`` handle
        (``ds._store[bb].read()`` returns whatever bytes are on disk,
        poisoned or not);
    (c) ``open()`` / ``np.fromfile`` a digest-sidecar path
        (``.ctt_checksums``) directly — sidecar state must flow through
        ``checksum_regions`` / ``checksum_entry`` / ``verify_region`` so
        the index cache and the policy layer stay coherent.
    """
    out: List[Finding] = []
    if module.tree is None or not _ct011_outside_io(module.path):
        return out
    for call in calls_in(module.tree):
        if isinstance(call.func, ast.Attribute):
            if call.func.attr == "_read_back":
                out.append(Finding(
                    "CT011", module.path, call.lineno, call.col_offset,
                    "raw '_read_back' outside io/: the bytes skip digest "
                    "verification, the missing-sidecar policy, and "
                    "lineage repair — read through the dataset API "
                    "(ds[bb] / read_async), which IS the verifying "
                    "reader",
                ))
                continue
            if call.func.attr in ("read", "write") and any(
                isinstance(n, ast.Attribute) and n.attr == "_store"
                for n in ast.walk(call.func.value)
            ):
                out.append(Finding(
                    "CT011", module.path, call.lineno, call.col_offset,
                    "raw '._store' access outside io/: a store-handle "
                    f"'{call.func.attr}' bypasses the verifying reader "
                    "(and the write-side sidecar recording) — use the "
                    "dataset API",
                ))
                continue
        seg = last_seg(dotted(call.func))
        if seg in _CT011_OPENERS:
            hit = None
            for n in ast.walk(call):
                s = str_const(n)
                if s and any(d in s for d in _CT011_SIDECAR_DIRS):
                    hit = s
                    break
            if hit is not None:
                out.append(Finding(
                    "CT011", module.path, call.lineno, call.col_offset,
                    f"raw '{seg}' of a digest-sidecar path ({hit!r}) "
                    "outside io/: sidecar state must flow through "
                    "checksum_regions/checksum_entry/verify_region so "
                    "the index cache and the missing-sidecar policy "
                    "stay coherent",
                ))
    return out


# =============================================================================
# CT012 - fleet hygiene
# =============================================================================

#: the fleet layer (docs/SERVING.md "Fleet"): the gateway/router module
#: (runtime/fleet.py) and the fleet CLI both answer to the name
_CT012_SCOPE = ("fleet.py",)

#: call segments that do a network round trip (the gateway's member-call
#: helpers plus the stdlib HTTP client surface) — forbidden under the
#: router's locks on top of CT009's blocking/IO sets: one slow member
#: probed under the placement lock head-of-line blocks every submit
_CT012_HTTP_CALLS = frozenset({
    "HTTPConnection", "urlopen", "getresponse", "request",
    "_member_call", "_call", "_call_once", "_probe_member", "healthz",
    "submit",
})

#: the adoption-claim API (runtime/fleet.py) — the only sanctioned
#: doorway to a peer's journal
_CT012_CLAIM_API = frozenset({
    "acquire_adoption_claim", "verify_adoption_claim",
    "read_adoption_claim", "release_adoption_claim", "read_peer_journal",
})

#: read entry points into a peer's journal that must be claim-gated
_CT012_JOURNAL_READS = frozenset({"scan", "recover", "journal_path"})


def ct012_fleet_hygiene(module: LintModule) -> List[Finding]:
    """Fleet-layer hygiene for the gateway/router (docs/SERVING.md
    "Fleet").

    (a) **Placement-lock discipline**: the router's locks guard pure
    bookkeeping (member table, affinity map, route table, counters) —
    no blocking calls, no storage IO, and, the fleet-specific extension,
    no HTTP (member calls, health probes) while holding them.  Every
    submit contends for the placement lock; one slow member probed under
    it freezes the whole fleet's intake.

    (b) **Journal adoption only through the claim API**: a peer's
    journal may only be read via ``read_peer_journal`` /
    ``verify_adoption_claim`` — no raw ``open()`` of a journal-named
    path, and no ``journal.scan``/``recover``/``journal_path`` reach
    into a peer outside a claim-holding scope.  Two servers replaying
    one journal double-run acknowledged work; the O_CREAT|O_EXCL claim
    file is the exactly-one-adopter proof, and this rule is what keeps
    every code path behind it.

    (c) **Drain protocol at the entry point**: any caller of
    ``serve_until_drained()`` must map ``DrainInterrupt`` to
    ``REQUEUE_EXIT_CODE`` (114) — a drained gateway that exits
    nonzero-as-crash breaks the rolling-restart protocol, same contract
    as CT009(c) for the single server.
    """
    is_fixture = "ct012" in module.name
    if module.name not in _CT012_SCOPE and not is_fixture:
        return []
    out: List[Finding] = []

    # -- (a) nothing slow under the router's bookkeeping locks -------------
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.With):
            continue
        keys = [
            k for k in (
                _lock_key(module, item.context_expr) for item in node.items
            ) if k is not None
        ]
        if not keys:
            continue
        held = keys[-1]
        for stmt in node.body:
            for inner in _walk_inline(stmt):
                if not isinstance(inner, ast.Call):
                    continue
                name = dotted(inner.func)
                seg = last_seg(name)
                if seg is None:
                    continue
                if seg in _BLOCKING_CALLS or (name or "").startswith(
                    "subprocess."
                ):
                    if seg == "join" and isinstance(
                        inner.func, ast.Attribute
                    ) and isinstance(inner.func.value, ast.Constant):
                        continue  # "sep".join(...) is not a thread join
                    out.append(Finding(
                        "CT012", module.path, inner.lineno,
                        inner.col_offset,
                        f"blocking call '{name}' while holding router "
                        f"lock '{held}': every submit contends for the "
                        "placement lock — wait outside the critical "
                        "section",
                    ))
                elif seg in _CT012_HTTP_CALLS:
                    out.append(Finding(
                        "CT012", module.path, inner.lineno,
                        inner.col_offset,
                        f"HTTP call '{name}' while holding router lock "
                        f"'{held}': one slow member probed under the "
                        "placement lock head-of-line blocks the whole "
                        "fleet's intake — snapshot under the lock, call "
                        "outside it",
                    ))
                elif seg in _CT009_IO_CALLS:
                    out.append(Finding(
                        "CT012", module.path, inner.lineno,
                        inner.col_offset,
                        f"storage IO '{name}' under router lock "
                        f"'{held}': state/failure writes must happen "
                        "after release — snapshot under the lock, write "
                        "outside it",
                    ))

    # -- (b) peer journals only through the adoption-claim API -------------
    def _claim_gated(call: ast.Call) -> bool:
        scope: Optional[ast.AST] = module.enclosing_function(call)
        while scope is not None:
            for c in calls_in(scope):
                if last_seg(dotted(c.func)) in _CT012_CLAIM_API:
                    return True
            scope = module.enclosing_function(scope)
        return False

    def _journal_arg(call: ast.Call) -> bool:
        # walk arg subtrees: "journal.log" inside os.path.join(...) is
        # still a journal path
        return any(
            _names_journal(dotted(n)) or _names_journal(str_const(n))
            for a in call.args
            for n in ast.walk(a)
        )

    for call in calls_in(module.tree):
        name = dotted(call.func)
        seg = last_seg(name)
        if seg == "open" or name == "os.open":
            if _journal_arg(call):
                out.append(Finding(
                    "CT012", module.path, call.lineno, call.col_offset,
                    "raw open of a journal path in the fleet layer: a "
                    "peer's journal may only be read via "
                    "read_peer_journal under the exclusive adoption "
                    "claim — two servers replaying one journal "
                    "double-run acknowledged work",
                ))
            continue
        if seg in _CT012_JOURNAL_READS:
            journalish = _names_journal(name) or _journal_arg(call)
            if journalish and not _claim_gated(call):
                out.append(Finding(
                    "CT012", module.path, call.lineno, call.col_offset,
                    f"journal read '{name}' outside a claim-holding "
                    "scope: adoption must verify the O_CREAT|O_EXCL "
                    "claim file first (acquire_adoption_claim / "
                    "verify_adoption_claim / read_peer_journal) — the "
                    "claim is the exactly-one-adopter proof",
                ))

    # -- (c) fleet entry points speak the drain protocol -------------------
    for call in calls_in(module.tree):
        if last_seg(dotted(call.func)) != "serve_until_drained":
            continue
        if not ("DrainInterrupt" in module.source
                and "REQUEUE_EXIT_CODE" in module.source):
            out.append(Finding(
                "CT012", module.path, call.lineno, call.col_offset,
                "serve_until_drained() raises DrainInterrupt after the "
                "drain, but this entry point never maps it to "
                "REQUEUE_EXIT_CODE: a SIGTERM'd gateway exits as a "
                "crash instead of a rolling-restart requeue",
            ))
    return out


# =============================================================================
# CT013 - gray-failure hygiene
# =============================================================================

#: outbound-connection constructors that, without an explicit deadline,
#: hang forever on a wedged peer (SYN-acked socket that never answers) —
#: the gray failure the breaker/hedging stack exists to bound
_CT013_NET_CALLS = frozenset({
    "HTTPConnection", "HTTPSConnection", "urlopen", "create_connection",
})

#: write paths that move acknowledged bytes to durable/visible places and
#: must therefore be fence-gated in server code: journal transitions and
#: handoff publishes.  A zombie server that was adopted away and still
#: reaches one of these double-writes acknowledged work.
_CT013_FENCED_WRITES = frozenset({"append_transition", "flush_namespace"})

#: the modules whose writes are fence-gated (the member server surface)
_CT013_FENCE_SCOPE = ("server.py",)


def ct013_grayfail_hygiene(module: LintModule) -> List[Finding]:
    """Gray-failure hygiene (docs/SERVING.md "Gray failures").

    (a) **Every outbound connection carries an explicit deadline**: an
    ``HTTPConnection``/``urlopen``/``create_connection`` without a
    ``timeout`` kwarg blocks forever on a wedged peer — the caller's
    thread is gone, no breaker ever trips, and the fleet degrades
    silently instead of failing over.  All serve-plane HTTP is supposed
    to go through ``runtime/netio.py`` (which always passes one); a raw
    deadline-less call is a hole in the gray-failure defense.

    (b) **Acknowledged writes in server code are fence-gated**: a
    ``journal.append_transition`` / ``handoff.flush_namespace`` call
    site in the member server whose enclosing scope shows no fencing
    evidence — neither a ``fence_guard.check()`` call nor a
    ``Fenced``-handling except — is a path a zombie can still write
    through after a survivor adopted its journal.  The fence epoch makes
    zombie double-writes structurally impossible only if every such
    write path re-validates the epoch first.
    """
    is_fixture = "ct013" in module.name
    out: List[Finding] = []

    # -- (a) no deadline-less outbound connections -------------------------
    for call in calls_in(module.tree):
        seg = last_seg(dotted(call.func))
        if seg not in _CT013_NET_CALLS:
            continue
        names, splat = kw_names(call)
        if "timeout" in names or splat:
            continue
        out.append(Finding(
            "CT013", module.path, call.lineno, call.col_offset,
            f"outbound connection '{seg}' without an explicit timeout "
            "kwarg: a wedged peer (accepted connection that never "
            "answers) blocks this caller forever and no circuit breaker "
            "ever trips — route serve-plane HTTP through "
            "runtime/netio.http_json_call, or pass timeout=",
        ))

    # -- (b) fence-gated acknowledged writes in the member server ----------
    if module.name not in _CT013_FENCE_SCOPE and not is_fixture:
        return out

    def _fence_guarded(call: ast.Call) -> bool:
        """Fencing evidence anywhere in the enclosing function chain: a
        ``*fence*.check()`` call, or an ``except ...Fenced`` handler
        (the append path itself re-validates under the journal lock and
        surfaces the verdict as the exception)."""
        scope: Optional[ast.AST] = module.enclosing_function(call)
        while scope is not None:
            for c in calls_in(scope):
                name = dotted(c.func) or ""
                if last_seg(name) == "check" and "fence" in name.lower():
                    return True
            for node in ast.walk(scope):
                if (isinstance(node, ast.ExceptHandler)
                        and node.type is not None):
                    if any(
                        "Fenced" in (dotted(n) or "")
                        for n in ast.walk(node.type)
                    ):
                        return True
            scope = module.enclosing_function(scope)
        return False

    for call in calls_in(module.tree):
        seg = last_seg(dotted(call.func))
        if seg not in _CT013_FENCED_WRITES:
            continue
        if _fence_guarded(call):
            continue
        out.append(Finding(
            "CT013", module.path, call.lineno, call.col_offset,
            f"acknowledged write '{seg}' with no fencing evidence in "
            "scope (no fence_guard.check() and no Fenced handler): a "
            "zombie server adopted away while wedged can still write "
            "through this path, double-running acknowledged work — "
            "re-validate the fence epoch before bytes move",
        ))
    return out


# =============================================================================
# CT014 - supervisor hygiene
# =============================================================================

#: the supervisor surface: the fleet CLI (now the supervisor process) and
#: the gateway/router module whose failover/scale-down helpers are
#: lifecycle decisions too
_CT014_SCOPE = ("fleet.py",)

#: journal-plane evidence for a lifecycle decision: a typed ledger record
#: or a durable failure-surface record in scope
_CT014_JOURNAL_EVIDENCE = frozenset({"append_transition", "record_failures"})

#: trace-plane evidence: the decision lands on the timeline
_CT014_TRACE_EVIDENCE = frozenset({"instant"})


def ct014_supervisor_hygiene(module: LintModule) -> List[Finding]:
    """Supervisor hygiene for the fleet's control plane (docs/SERVING.md
    "Supervision").

    (a) **Every lifecycle decision is journaled AND traced**: a call
    site that spawns/respawns a process (``*spawn*``, ``Popen``) or
    scales the fleet down (``drain_emptiest``) must show journal-plane
    evidence (``append_transition``/``record_failures`` or a
    ``*journal_decision*`` helper) and trace-plane evidence
    (``trace.instant`` or the same helper) — in the enclosing function
    chain or directly in the same-module definition of the called
    helper.  An unjournaled respawn/scale decision makes a healed fleet
    unauditable: nobody can replay WHY capacity changed, which is the
    difference between a control loop and a haunted house.

    (b) **No process spawn or blocking wait under a lock**: extending
    CT012(a), a ``subprocess.Popen``/``subprocess.*`` call or a blocking
    wait (``sleep``/``wait``/``join``/``result``) while holding any
    ``*lock*``-named context serializes fork+exec (or a child's whole
    lifetime) behind bookkeeping every submit contends for.  The
    supervisor is single-threaded by design; anything lock-shaped in
    this layer must stay pure bookkeeping.
    """
    is_fixture = "ct014" in module.name
    if module.name not in _CT014_SCOPE and not is_fixture:
        return []
    out: List[Finding] = []

    defs_by_name: Dict[str, ast.AST] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, node)

    def _evidence_in(scope: ast.AST) -> Tuple[bool, bool]:
        journaled = traced = False
        for c in calls_in(scope):
            seg = last_seg(dotted(c.func)) or ""
            if "journal_decision" in seg:
                # the canonical helper writes both planes at once
                journaled = traced = True
            if seg in _CT014_JOURNAL_EVIDENCE:
                journaled = True
            if seg in _CT014_TRACE_EVIDENCE:
                traced = True
        return journaled, traced

    def _decision_evidence(call: ast.Call,
                           callee_seg: str) -> Tuple[bool, bool]:
        journaled = traced = False
        scope: Optional[ast.AST] = module.enclosing_function(call)
        while scope is not None:
            j, t = _evidence_in(scope)
            journaled, traced = journaled or j, traced or t
            scope = module.enclosing_function(scope)
        # one level into the called helper: a spawn wrapper that
        # journals inside its own body covers all its call sites
        target = defs_by_name.get(callee_seg)
        if target is not None:
            j, t = _evidence_in(target)
            journaled, traced = journaled or j, traced or t
        return journaled, traced

    # -- (a) spawn/scale decisions carry journal + trace evidence ----------
    for call in calls_in(module.tree):
        seg = last_seg(dotted(call.func))
        if seg is None:
            continue
        low = seg.lower()
        if "journal_decision" in low:
            continue  # the evidence helper is not itself a decision
        if not (seg == "Popen" or "spawn" in low
                or seg == "drain_emptiest"):
            continue
        journaled, traced = _decision_evidence(call, seg)
        if not journaled:
            out.append(Finding(
                "CT014", module.path, call.lineno, call.col_offset,
                f"lifecycle decision '{seg}' with no journal-plane "
                "evidence in scope (append_transition / record_failures "
                "/ a *journal_decision* helper): an unjournaled "
                "respawn/scale decision cannot be replayed or "
                "attributed after the fleet heals itself",
            ))
        if not traced:
            out.append(Finding(
                "CT014", module.path, call.lineno, call.col_offset,
                f"lifecycle decision '{seg}' with no trace-plane "
                "evidence in scope (trace.instant / a *journal_decision* "
                "helper): supervisor decisions must land on the trace "
                "timeline next to the work they moved",
            ))

    # -- (b) no fork+exec or blocking wait under a lock --------------------
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.With):
            continue
        keys = [
            k for k in (
                _lock_key(module, item.context_expr) for item in node.items
            ) if k is not None
        ]
        if not keys:
            continue
        held = keys[-1]
        for stmt in node.body:
            for inner in _walk_inline(stmt):
                if not isinstance(inner, ast.Call):
                    continue
                name = dotted(inner.func)
                seg = last_seg(name)
                if seg is None:
                    continue
                if seg == "join" and isinstance(
                    inner.func, ast.Attribute
                ) and isinstance(inner.func.value, ast.Constant):
                    continue  # "sep".join(...) is not a thread join
                if (seg == "Popen"
                        or (name or "").startswith("subprocess.")
                        or seg in _BLOCKING_CALLS):
                    out.append(Finding(
                        "CT014", module.path, inner.lineno,
                        inner.col_offset,
                        f"process spawn / blocking wait '{name}' while "
                        f"holding lock '{held}': fork+exec (or a "
                        "child's lifetime) serialized behind supervisor "
                        "bookkeeping — decide under the lock, spawn "
                        "outside it",
                    ))
    return out


# =============================================================================
# CT015 - reduce-plane discipline
# =============================================================================

#: the reduce-plane surface: the tree's solver (both planes) and the
#: multihost wiring that probes collective support
_CT015_SCOPE = ("reduce_tree.py", "multihost.py")

#: waits on the reduce plane and the patience evidence each must carry:
#: ``callee -> (min_positional_args_that_satisfy, accepted_kwargs)``.
#: ``_wait_npz(path, wait_s)`` satisfies positionally; the collective
#: level dispatch and the support probe must name their deadline.
_CT015_WAITS: Dict[str, Tuple[Optional[int], frozenset]] = {
    "_wait_npz": (2, frozenset({"wait_s", "deadline"})),
    "solve_level": (None, frozenset({"deadline_s", "hop_deadline_s"})),
    "collectives_supported": (1, frozenset({"deadline_s", "timeout"})),
}


def ct015_reduce_plane_discipline(module: LintModule) -> List[Finding]:
    """Reduce-plane discipline (docs/PERFORMANCE.md "Collective reduce
    plane").

    (a) **No unbounded waits on the reduce plane**: every collective hop
    (``solve_level`` dispatch, ``collectives_supported`` probe) and every
    packet poll (``_wait_npz``) must carry an explicit deadline/patience
    argument.  A deadline-less hop turns one dead worker into a wedged
    worker *group*: siblings block forever on a packet or a collective
    that is never coming, and the caller's own timeout is the only thing
    left to notice — minutes instead of one patience window.

    (b) **Every ``degraded:packet_plane`` fallback site writes a failures
    record**: a function whose body mentions the resolution string must
    show a ``record_failures`` call — in its own body or one level into a
    same-module helper it calls (the CT014 evidence walk).  A silent
    degradation leaves io_metrics claiming collectives ran while every
    level quietly went through the filesystem; the failures record is
    what makes the ladder auditable.
    """
    is_fixture = "ct015" in module.name
    if module.name not in _CT015_SCOPE and not is_fixture:
        return []
    out: List[Finding] = []

    # -- (a) every hop/poll carries patience -------------------------------
    for call in calls_in(module.tree):
        seg = last_seg(dotted(call.func))
        if seg not in _CT015_WAITS:
            continue
        min_pos, accepted = _CT015_WAITS[seg]
        names, splat = kw_names(call)
        if splat or (names & accepted):
            continue
        if min_pos is not None and len(call.args) >= min_pos:
            continue
        out.append(Finding(
            "CT015", module.path, call.lineno, call.col_offset,
            f"reduce-plane wait '{seg}' without an explicit "
            f"deadline/patience argument ({sorted(accepted)}): an "
            "unbounded hop lets one dead worker wedge the whole group — "
            "every packet poll and collective dispatch must be able to "
            "declare the hop lost",
        ))

    # -- (b) degraded:packet_plane sites write a failures record -----------
    defs_by_name: Dict[str, ast.AST] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, node)

    def _writes_failures(scope: ast.AST, depth: int = 1) -> bool:
        for c in calls_in(scope):
            seg = last_seg(dotted(c.func))
            if seg == "record_failures":
                return True
            if depth and seg in defs_by_name and _writes_failures(
                defs_by_name[seg], depth - 1
            ):
                return True
        return False

    for node in ast.walk(module.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mentions = any(
            "degraded:packet_plane" in (str_const(n) or "")
            for n in ast.walk(node)
        )
        if not mentions:
            continue
        if _writes_failures(node):
            continue
        out.append(Finding(
            "CT015", module.path, node.lineno, node.col_offset,
            f"'{node.name}' degrades to the packet plane "
            "(degraded:packet_plane) without failures-record evidence "
            "(record_failures in its body or a same-module helper it "
            "calls): silent degradation makes the collective/packet "
            "ladder unauditable",
        ))
    return out


# =============================================================================
# registry
# =============================================================================

RULES = {
    "CT001": ct001_executor_contract,
    "CT002": ct002_atomic_writes,
    "CT003": ct003_lock_discipline,
    "CT004": ct004_fault_site_coverage,
    "CT005": ct005_device_hygiene,
    "CT006": ct006_drain_safety,
    "CT007": ct007_memory_target_contract,
    "CT008": ct008_trace_hygiene,
    "CT009": ct009_server_hygiene,
    "CT010": ct010_journal_discipline,
    "CT011": ct011_verified_read_discipline,
    "CT012": ct012_fleet_hygiene,
    "CT013": ct013_grayfail_hygiene,
    "CT014": ct014_supervisor_hygiene,
    "CT015": ct015_reduce_plane_discipline,
}
