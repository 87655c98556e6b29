"""AST-based dygraph->static conversion (`@to_static` control flow).

Counterpart of ``paddle_tpu/dygraph/dy2static.py``: the AST half is the
same code; the runtime shims build the port's tensors.  A shim's truth
test of a card tensor (``_truth``) is a host read, made while the trace
runs the Python body, never inside a lowering: the recorded
``cond_pair``/``while`` ops read their predicates when the executor
runs them (``ops/control_flow.py``).

Role parity: reference python/paddle/fluid/dygraph/dygraph_to_static/
(program_translator.py, ast_transformer.py, ifelse_transformer.py,
loop_transformer.py, break_continue_transformer.py, convert_operators.py)
— the 25-file transpiler collapsed to one module by the same two-phase
design the reference uses:

1. **Compile time**: the function's AST is rewritten once.  `if`/`while`/
   `for range(...)` over possibly-tensor values become calls into the
   `convert_*` runtime shims, with the branch/loop bodies extracted into
   local functions that take the written-to variables as arguments and
   return them (undefined-before-branch names are passed as a loud
   ``_UNDEF`` sentinel, the reference's UndefinedVar).  `break`/
   `continue` are rewritten into guard flags exactly like the
   reference's BreakContinueTransformer; `and`/`or`/`not` become lazy
   `convert_logical_*` calls that preserve python short-circuiting.

2. **Runtime**: each shim dispatches on the condition's actual type —
   plain python values take the ordinary python path (zero overhead for
   non-tensor control flow), static-graph `Variable`s build
   `layers.cond`/`layers.while_loop` ops, and dygraph Tensors under an
   active trace record real `cond_pair`/`while` ops with sub-blocks
   into the traced program, so `jit.save` exports data-dependent
   control flow instead of baking in one branch.
"""
from __future__ import annotations

import ast
import inspect
import sys
import textwrap
from typing import List

import numpy as np

from ..framework import unique_name


class _Undefined:
    """Loud placeholder for names not yet bound when a branch runs
    (reference UndefinedVar): any actual USE raises immediately."""

    def __init__(self, name):
        self._name = name

    def _die(self, *a, **k):
        raise NameError(
            f"variable {self._name!r} is used in a converted branch/loop "
            f"before being assigned on every path; give it a value before "
            f"the if/loop")

    __call__ = __add__ = __radd__ = __sub__ = __mul__ = __bool__ = _die
    __getattr__ = __getitem__ = __float__ = __int__ = _die

    def __repr__(self):
        return f"<undefined {self._name}>"


def _is_dytensor(x):
    from .tensor import Tensor

    return isinstance(x, Tensor)


def _is_static_var(x):
    from ..framework.program import Variable

    return isinstance(x, Variable)


def _truth(x):
    if isinstance(x, _Undefined):
        x._die()
    return bool(x)


def _tracing():
    from . import eager

    return eager._TRACE_REC


class _suspend_trace:
    def __enter__(self):
        from . import eager

        self._rec = eager._TRACE_REC
        eager._TRACE_REC = None

    def __exit__(self, *exc):
        from . import eager

        eager._TRACE_REC = self._rec
        return False


def _wrap_tensor(v, like=None):
    """``v`` as a Tensor; a Python value becomes one on ``like``'s device
    (the current device without one)."""
    from .tensor import Tensor, _as_torch

    if isinstance(v, _Undefined):
        v._die()
    if _is_dytensor(v):
        return v
    dev = like._value.device if _is_dytensor(like) else None
    return Tensor(_as_torch(np.asarray(v), dev))


def _flat(res):
    if isinstance(res, tuple):
        return list(res), True
    return [res], False


def _fresh_like(t):
    """New Tensor object over the same value (so binding it to a new var
    name leaves the source object's name untouched)."""
    from .tensor import Tensor

    nt = Tensor(t._value)
    nt.stop_gradient = getattr(t, "stop_gradient", True)
    return nt


def _device_like(vals):
    """The first tensor among ``vals`` (where new constants go)."""
    return next((v for v in vals if _is_dytensor(v)), None)


# ---------------------------------------------------------------------------
# runtime shims
# ---------------------------------------------------------------------------

def convert_ifelse(pred, true_fn, false_fn, names, caller_locals,
                   returning=False):
    """Reference convert_operators.convert_ifelse."""
    args = tuple(caller_locals.get(n, _Undefined(n)) for n in names)
    if _is_static_var(pred):
        from .. import layers

        out = layers.cond(pred, lambda: true_fn(*args),
                          lambda: false_fn(*args))
        return out
    rec = _tracing()
    if rec is not None and _is_dytensor(pred):
        return _trace_ifelse(rec, pred, true_fn, false_fn, args)
    return true_fn(*args) if _truth(pred) else false_fn(*args)


def _trace_ifelse(rec, pred, true_fn, false_fn, args):
    pred_name = rec.ensure_name(pred)
    parent = rec.block

    def capture(fn):
        sub = rec.begin_sub_block()
        res = fn(*args)
        vals, is_tuple = _flat(res)
        ts = [_wrap_tensor(v, pred) for v in vals]
        names = [rec.ensure_name(t) for t in ts]
        rec.end_sub_block(parent)
        return sub, res, ts, names, is_tuple

    sub_t, t_res, t_ts, t_names, t_tuple = capture(true_fn)
    sub_f, f_res, f_ts, f_names, f_tuple = capture(false_fn)
    if len(t_names) != len(f_names) or t_tuple != f_tuple:
        raise TypeError(
            f"converted if/else branches return different structures "
            f"({len(t_names)} vs {len(f_names)} values)")

    taken_ts = t_ts if _truth(pred) else f_ts
    out_names = []
    for t in taken_ts:
        name = rec.new_parent_var(parent, t)
        out_names.append(name)
    parent.append_op("cond_pair", {"Cond": [pred_name]},
                     {"Out": out_names},
                     {"sub_block_t": sub_t.idx, "sub_block_f": sub_f.idx,
                      "t_outs": t_names, "f_outs": f_names})
    # bind FRESH tensor objects to the cond outputs: a passthrough branch
    # returns the caller's own tensor, and re-pointing that object would
    # clobber the name every other reference to the original value uses
    outs = []
    for t, n in zip(taken_ts, out_names):
        nt = _fresh_like(t)
        rec.bind(nt, n)
        outs.append(nt)
    if t_tuple:
        return tuple(outs)
    return outs[0]


def ret_select(flag, then_fn, else_fn):
    """Value select for the rewritten return cascade
    (_ReturnRewriter): chooses the fired return site's expression.
    Python flags evaluate only the taken leg; tensor flags trace both
    and merge (layers.cond in static graphs, cond_pair under trace)."""
    if _is_static_var(flag):
        from .. import layers

        return layers.cond(flag, then_fn, else_fn)
    rec = _tracing()
    if rec is not None and _is_dytensor(flag):
        return _trace_ifelse(rec, flag, lambda: then_fn(),
                             lambda: else_fn(), ())
    return then_fn() if _truth(flag) else else_fn()


def convert_while_loop(cond_fn, body_fn, names, caller_locals):
    """Reference convert_operators.convert_while_loop."""
    args = tuple(caller_locals.get(n, _Undefined(n)) for n in names)
    probe = cond_fn(*args)
    if _is_static_var(probe):
        from .. import layers

        out = layers.while_loop(lambda *vs: cond_fn(*vs),
                                lambda *vs: list(body_fn(*vs)),
                                list(args))
        return tuple(out)
    rec = _tracing()
    if rec is not None and _is_dytensor(probe):
        return _trace_while(rec, cond_fn, body_fn, args, probe)
    # plain python — but under an active trace the condition can BECOME
    # a tensor mid-loop (a python-range loop whose break flag is data-
    # dependent): peel the already-run iterations and hand the rest to
    # the traced while op
    vals = args
    c = probe
    while True:
        if rec is not None and _is_dytensor(c):
            return _trace_while(rec, cond_fn, body_fn, tuple(vals), c)
        if not _truth(c):
            return vals
        vals = body_fn(*vals)
        c = cond_fn(*vals)


def _trace_while(rec, cond_fn, body_fn, args, probe=None):
    # python scalars join the carry as tensors (loop state is named
    # vars); UNDEF entering the carry dies only when actually used
    like = _device_like(args + (probe,))
    vals = tuple(
        v if isinstance(v, _Undefined) else _wrap_tensor(v, like)
        for v in args)
    parent = rec.block

    def carry_name(v):
        """A loop-carried var must be a per-call TEMPORARY: captured
        python scalars (break/return flags) land in persistable consts,
        and carrying the const itself would make the while's write-back
        mutate saved state — replay N's final flag would become replay
        N+1's initial value.  Copy persistables into a parent temp and
        carry that."""
        n = rec.ensure_name(v)
        var = parent._find_var_recursive(n)
        if var is not None and getattr(var, "persistable", False):
            tmp = rec.new_parent_var(parent, v)
            parent.append_op("assign", {"X": [n]}, {"Out": [tmp]}, {})
            rec.bind(v, tmp)
            return tmp
        return n

    var_names = [carry_name(v) if not isinstance(v, _Undefined)
                 else None for v in vals]

    if probe is not None and all(v is a for v, a in zip(vals, args)):
        # wrapping changed nothing: the dispatch probe already recorded
        # the condition ops — do not duplicate them in the parent block
        pre = probe
    else:
        # python scalars got wrapped, so the probe's recorded cond ops
        # read baked constants and MUST be recomputed over the carried
        # tensors; the probe's ops stay as dead code the export path
        # prunes (prune_program backward slice)
        pre = cond_fn(*vals)  # recorded in the parent block
    cond_name = rec.ensure_name(pre)

    sub = rec.begin_sub_block()
    new_vals = body_fn(*vals)
    if len(new_vals) != len(vals):
        raise TypeError(
            f"converted loop body returned {len(new_vals)} values, "
            f"expected {len(vals)}")
    new_cond = cond_fn(*new_vals)
    # write-back is a PARALLEL assignment: a body like `i = it; it += 1`
    # hands var i the tensor previously NAMED it, so all new values are
    # copied to temps before any carried name is overwritten
    updates = []
    for old_name, nv in zip(var_names, new_vals):
        if old_name is None:
            continue  # UNDEF never materialized: not carried
        updates.append((rec.ensure_name(_wrap_tensor(nv, like)), old_name))
    updates.append((rec.ensure_name(_wrap_tensor(new_cond, like)),
                    cond_name))
    staged = []
    for nv_name, old_name in updates:
        if nv_name == old_name:
            continue
        tmp = unique_name.generate("whilewb")
        rec.block.create_var(name=tmp, shape=(), dtype="float32")
        rec.block.append_op("assign", {"X": [nv_name]}, {"Out": [tmp]}, {})
        staged.append((tmp, old_name))
    for tmp, old_name in staged:
        rec.block.append_op("assign", {"X": [tmp]}, {"Out": [old_name]}, {})
    rec.end_sub_block(parent)

    carried = [cond_name] + [n for n in var_names if n is not None]
    parent.append_op("while", {"X": carried, "Condition": [cond_name]},
                     {"Out": list(carried)}, {"sub_block": sub.idx})

    # finish the EAGER computation unrecorded: the trace holds one body;
    # the value flowing onward must be the true fixed point
    if not _truth(pre):
        final = vals
    else:
        final = tuple(new_vals)
        with _suspend_trace():
            while _truth(cond_fn(*final)):
                final = tuple(body_fn(*final))
    outs = []
    for v, n in zip(final, var_names):
        if n is None or isinstance(v, _Undefined):
            outs.append(v)
            continue
        nt = _fresh_like(_wrap_tensor(v, like))
        rec.bind(nt, n)
        outs.append(nt)
    return tuple(outs)


def _eager_logical(op_type, x, y=None):
    from . import eager

    like = _device_like((x, y))
    ins = {"X": _wrap_tensor(x, like)}
    if y is not None:
        ins["Y"] = _wrap_tensor(y, like)
    return eager.run_op(op_type, ins)["Out"]


def convert_logical_and(lhs_fn, rhs_fn):
    l = lhs_fn() if callable(lhs_fn) else lhs_fn
    if _is_static_var(l):
        from .. import layers

        return layers.logical_and(l, rhs_fn())
    if _is_dytensor(l):
        return _eager_logical("logical_and", l, rhs_fn())
    return rhs_fn() if _truth(l) else l


def convert_logical_or(lhs_fn, rhs_fn):
    l = lhs_fn() if callable(lhs_fn) else lhs_fn
    if _is_static_var(l):
        from .. import layers

        return layers.logical_or(l, rhs_fn())
    if _is_dytensor(l):
        return _eager_logical("logical_or", l, rhs_fn())
    return l if _truth(l) else rhs_fn()


def convert_logical_not(x):
    if _is_static_var(x):
        from .. import layers

        return layers.logical_not(x)
    if _is_dytensor(x):
        return _eager_logical("logical_not", x)
    return not _truth(x)


def assert_plain_if(pred):
    """Truth-test for an if/else left in python form because its return
    shape cannot convert: LOUD when the condition is actually a traced
    tensor (silently baking one branch is worse than an error)."""
    if _tracing() is not None and _is_dytensor(pred):
        raise NotImplementedError(
            "to_static cannot convert an early `return` inside an "
            "if/else over a TENSOR condition unless both branches end "
            "in a return statement; restructure the early return")
    return _truth(pred)


def to_bool(x):
    """Eager truth value for the real break/continue guards kept inside
    python container loops (tensors evaluate eagerly)."""
    return _truth(x)


def convert_iterable(it):
    """for-over-tensor support (reference dygraph_to_static/
    break_continue_transformer.py:31 ForToWhileTransformer +
    list_transformer.py:90 list semantics): a tensor with a static
    leading dim iterates as its rows.  The loop is UNROLLED: each row
    access records a slice op, and python-list
    accumulation (append in the loop, concat/stack after) works
    unchanged because the list lives at trace time."""
    if _is_static_var(it) or _is_dytensor(it):
        shape = getattr(it, "shape", None)
        if not shape or shape[0] is None or int(shape[0]) < 0:
            raise NotImplementedError(
                "to_static can only iterate a tensor whose leading "
                "dimension is static; got shape " + repr(shape))
        n = int(shape[0])
        if _is_static_var(it):
            from .. import layers

            return [layers.squeeze(
                layers.slice(it, axes=[0], starts=[k], ends=[k + 1]),
                axes=[0]) for k in range(n)]
        # dygraph: rows come from the IR slice op (run_op records it on
        # an active trace — plain tensor indexing would be trace-invisible
        # and bake the traced input's rows as constants)
        from .eager import run_op

        return [run_op("slice", {"Input": it},
                       {"axes": [0], "starts": [k], "ends": [k + 1],
                        "decrease_axis": [0]})["Out"]
                for k in range(n)]
    return it


def init_loop_var(caller_locals, name, default):
    """Initial carry for a for-range loop variable: python leaves a
    pre-existing variable untouched when the range is empty, so reuse
    the current binding when one exists."""
    if name in caller_locals:
        return caller_locals[name]
    return default


def range_cond(i, stop, step):
    """Loop-continuation test for a ``for i in range(...)`` rewrite."""
    if isinstance(step, (int, float)):
        up = step > 0
    else:
        up = _truth(step > 0)  # tensor step: sign fixed at trace time
    return (i < stop) if up else (i > stop)


# ---------------------------------------------------------------------------
# AST transformation
# ---------------------------------------------------------------------------

def _assigned_names(stmts) -> List[str]:
    names: set = set()

    class V(ast.NodeVisitor):
        def _tgt(self, t):
            if isinstance(t, ast.Name):
                names.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._tgt(e)

        def visit_Assign(self, n):
            for t in n.targets:
                self._tgt(t)
            self.generic_visit(n)

        def visit_AugAssign(self, n):
            self._tgt(n.target)
            self.generic_visit(n)

        def visit_AnnAssign(self, n):
            if n.value is not None:
                self._tgt(n.target)
            self.generic_visit(n)

        def visit_For(self, n):
            self._tgt(n.target)
            self.generic_visit(n)

        def visit_FunctionDef(self, n):
            names.add(n.name)  # the def binds its name; don't descend

        visit_AsyncFunctionDef = visit_FunctionDef

    v = V()
    for s in stmts:
        v.visit(s)
    return sorted(names)


_GEN_PREFIXES = ("_pt_t_", "_pt_f_", "_pt_wc_", "_pt_wb_", "_pt_void_")


def _user_names(names):
    """Drop the converter's own generated function/temp names."""
    return [n for n in names if not n.startswith(_GEN_PREFIXES)]


def _contains_break_or_continue(stmts) -> bool:
    """break/continue belonging to THIS loop level (nested loops and
    function defs own theirs)."""
    def scan(node) -> bool:
        if isinstance(node, (ast.Break, ast.Continue)):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.For, ast.While)):
            return False
        return any(scan(c) for c in ast.iter_child_nodes(node))

    return any(scan(s) for s in stmts)


def _contains_return(stmts) -> bool:
    """True if a `return` occurs at THIS function's level — nested
    function defs (incl. converted _pt_* branch functions) open their
    own scope and must not count."""
    def scan(node) -> bool:
        if isinstance(node, ast.Return):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return False
        return any(scan(c) for c in ast.iter_child_nodes(node))

    return any(scan(s) for s in stmts)


def _parse_stmts(src: str):
    return ast.parse(textwrap.dedent(src)).body


def _indent(stmts, pad="    "):
    if not stmts:
        return pad + "pass"
    return textwrap.indent("\n".join(ast.unparse(s) for s in stmts), pad)


class _BreakContinueRewriter:
    """Reference break_continue_transformer.py: break/continue inside a
    loop body become flag assignments; trailing statements get wrapped
    in a not-flagged guard."""

    def __init__(self, n):
        self.brk = f"_pt_brk_{n}"
        self.cont = f"_pt_cont_{n}"
        self.brk_used = False
        self.cont_used = False

    def guard_expr(self) -> str:
        flags = []
        if self.brk_used:
            flags.append(self.brk)
        if self.cont_used:
            flags.append(self.cont)
        if len(flags) == 2:
            inner = (f"_jst.convert_logical_or(lambda: {flags[0]}, "
                     f"lambda: {flags[1]})")
        else:
            inner = flags[0]
        return f"_jst.convert_logical_not({inner})"

    def rewrite(self, stmts):
        """Each break/continue site guards its OWN remainder (nested
        guards, like the reference's per-region wrapping) so a second
        site firing mid-guard still skips the statements after it."""
        out = []
        for idx, st in enumerate(stmts):
            st2, h = self._stmt(st)
            out.extend(st2 if isinstance(st2, list) else [st2])
            if h:
                rest, _ = self.rewrite(stmts[idx + 1:])
                if rest:
                    guard = ast.parse(
                        f"if {self.guard_expr()}:\n    pass").body[0]
                    guard.body = rest
                    out.append(guard)
                return out, True
        return out, False

    def _stmt(self, st):
        if isinstance(st, ast.Break):
            self.brk_used = True
            return _parse_stmts(f"{self.brk} = True"), True
        if isinstance(st, ast.Continue):
            self.cont_used = True
            return _parse_stmts(f"{self.cont} = True"), True
        if isinstance(st, ast.If):
            body, h1 = self.rewrite(st.body)
            orelse, h2 = (self.rewrite(st.orelse) if st.orelse
                          else ([], False))
            if h1 or h2:
                new = ast.If(test=st.test, body=body, orelse=orelse)
                return ast.copy_location(new, st), True
            return st, False
        # nested loops own their break/continue; defs open a new scope
        return st, False


def _legacy_return_ok(stmts) -> bool:
    """True when every `return` already sits where the direct conversion
    handles it: the block's final statement, or a tail-position if/else
    whose BOTH branches end in return.  Anything else (return in a loop,
    guard-style early return, mixed forms) goes through _ReturnRewriter.
    """
    for i, s in enumerate(stmts):
        if not _contains_return([s]):
            continue
        tail = i == len(stmts) - 1
        if isinstance(s, ast.Return):
            if not tail:
                return False
        elif isinstance(s, ast.If):
            if not (tail and s.body and s.orelse
                    and isinstance(s.body[-1], ast.Return)
                    and isinstance(s.orelse[-1], ast.Return)
                    and _legacy_return_ok(s.body[:-1] or [])
                    and _legacy_return_ok(s.orelse[:-1] or [])):
                return False
        else:
            return False
    return True


class _ReturnRewriter:
    """Reference dygraph_to_static/return_transformer.py:135, in a form
    that fits the trace machinery: each return SITE k becomes a boolean
    flag assignment ``_pt_ret_f<k> = True`` (plus ``break`` inside
    loops — the loop converter folds it into the loop condition for
    tensor flags); statements after a possibly-returning construct are
    guarded by ``not (f1 or f2 or ...)``; and the function closes with
    ONE nested select ``ret_select(f1, e1, ret_select(f2, e2, tail))``
    that re-evaluates each site's expression at function end.

    Why flags-only (no carried return VALUE): a carried value would
    need a typed initial placeholder before the first loop, which is
    unknowable statically.  Re-evaluating e_k at the end is sound
    because once a flag fires every later statement is guarded, so the
    variables e_k reads still hold their values from the firing point
    (loop vars exit through the normal carry)."""

    def __init__(self):
        self.flags: List[str] = []
        self.sites: List = []  # [(flag, expr_src)] in program order
        self.tail_expr = "None"

    def _fired(self):
        return " or ".join(self.flags) if self.flags else "False"

    def rewrite_function(self, fdef):
        body = self._block(list(fdef.body), in_loop=False, top=True)
        init = _parse_stmts(
            "\n".join(f"{f} = False" for f in self.flags))
        ret = "(" + self.tail_expr + ")"
        for f, e in reversed(self.sites):
            ret = (f"_jst.ret_select({f}, lambda: ({e}), "
                   f"lambda: {ret})")
        fdef.body = init + body + _parse_stmts(f"return {ret}")

    def _block(self, stmts, in_loop, top=False):
        out = []
        for idx, s in enumerate(stmts):
            if isinstance(s, ast.Return):
                expr = ast.unparse(s.value) if s.value is not None \
                    else "None"
                if top and idx == len(stmts) - 1:
                    self.tail_expr = expr  # the default select leg
                    return out
                flag = f"_pt_ret_f{len(self.flags) + 1}"
                self.flags.append(flag)
                self.sites.append((flag, expr))
                out += _parse_stmts(f"{flag} = True")
                if in_loop:
                    out.append(ast.Break())
                return out  # statements after `return` are unreachable
            if not _contains_return([s]):
                out.append(s)
                continue
            if isinstance(s, ast.If):
                s.body = self._block(s.body, in_loop)
                s.orelse = self._block(s.orelse, in_loop)
            elif isinstance(s, (ast.While, ast.For)):
                s.body = self._block(s.body, in_loop=True)
            else:
                raise NotImplementedError(
                    f"to_static does not support `return` inside a "
                    f"{type(s).__name__.lower()} block")
            out.append(s)
            if in_loop:
                # the construct may have fired a return: exit the
                # ENCLOSING loop too
                out += _parse_stmts(f"if {self._fired()}:\n    break")
            rest = self._block(list(stmts[idx + 1:]), in_loop, top=top)
            if rest:
                guard = ast.parse(
                    f"if _jst.convert_logical_not({self._fired()}):\n"
                    f"    pass").body[0]
                guard.body = rest
                out.append(guard)
            return out
        return out


def _is_append_stmt(s):
    return (isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
            and isinstance(s.value.func, ast.Attribute)
            and s.value.func.attr == "append"
            and isinstance(s.value.func.value, ast.Name)
            and len(s.value.args) == 1 and not s.value.keywords)


def _branch_appends(stmts):
    """Top-level ``name.append(expr)`` statements: [(list_name, idx)]."""
    return [(s.value.func.value.id, i) for i, s in enumerate(stmts)
            if _is_append_stmt(s)]


def _replace_append(stmts, lname, tmp):
    """Swap the first top-level ``lname.append(e)`` for ``tmp = e``."""
    for i, s in enumerate(stmts):
        if _is_append_stmt(s) and s.value.func.value.id == lname:
            stmts[i] = ast.copy_location(
                _parse_stmts(f"{tmp} = {ast.unparse(s.value.args[0])}")[0],
                s)
            return


class _Dy2StaticTransformer(ast.NodeTransformer):
    def __init__(self):
        self.n = 0

    def _next(self):
        self.n += 1
        return self.n

    # -- boolean ops --------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        conv = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        expr = ast.unparse(node.values[0])
        for v in node.values[1:]:
            expr = f"_jst.{conv}(lambda: ({expr}), lambda: " \
                   f"({ast.unparse(v)}))"
        return ast.parse(expr, mode="eval").body

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.parse(
                f"_jst.convert_logical_not({ast.unparse(node.operand)})",
                mode="eval").body
        return node

    # -- if/else ------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        i = self._next()
        has_ret = _contains_return(node.body) or _contains_return(node.orelse)
        outs = sorted(set(_user_names(_assigned_names(node.body)))
                      | set(_user_names(_assigned_names(node.orelse))))
        arglist = ", ".join(outs)
        names_lit = repr(tuple(outs))
        test_src = ast.unparse(node.test)

        if has_ret:
            def last_is_return(stmts):
                return (bool(stmts) and isinstance(stmts[-1], ast.Return)
                        and not _contains_return(stmts[:-1]))

            if not (last_is_return(node.body) and last_is_return(node.orelse)):
                # guard-style early return (`if cond: return x`): keep
                # plain python, but the shimmed test raises if the
                # condition turns out to be a traced tensor — a python
                # guard keeps working, a data-dependent one stays LOUD
                # instead of silently baking one branch
                guarded = ast.parse(
                    f"if _jst.assert_plain_if(({test_src})):\n    pass"
                ).body[0]
                guarded.body = node.body
                guarded.orelse = node.orelse
                return ast.copy_location(guarded, node)
            t_ret = ast.unparse(node.body[-1].value) \
                if node.body[-1].value is not None else "None"
            f_ret = ast.unparse(node.orelse[-1].value) \
                if node.orelse[-1].value is not None else "None"
            src = (
                f"def _pt_t_{i}({arglist}):\n"
                f"{_indent(node.body[:-1])}\n"
                f"    return {t_ret}\n"
                f"def _pt_f_{i}({arglist}):\n"
                f"{_indent(node.orelse[:-1])}\n"
                f"    return {f_ret}\n"
                f"return _jst.convert_ifelse(({test_src}), _pt_t_{i}, "
                f"_pt_f_{i}, {names_lit}, locals(), returning=True)\n"
            )
            return _parse_stmts(src)

        # list_transformer role (reference list_transformer.py:90):
        # symmetric `L.append(e)` in both branches hoists to a merged
        # temp assigned in each branch + ONE append after the merge, so
        # the appended value is a parent-block cond output instead of a
        # sub-block temp the rest of the graph cannot read
        post = []
        appends_t = _branch_appends(node.body)
        appends_f = _branch_appends(node.orelse)
        if appends_t and [a[0] for a in appends_t] == \
                [a[0] for a in appends_f]:
            for k, ((lname, _), _) in enumerate(zip(appends_t, appends_f)):
                tmp = f"_pt_app_{i}_{k}"
                _replace_append(node.body, lname, tmp)
                _replace_append(node.orelse, lname, tmp)
                post += _parse_stmts(f"{lname}.append({tmp})")
            outs = sorted(set(outs)
                          | {f"_pt_app_{i}_{k}"
                             for k in range(len(appends_t))})
            arglist = ", ".join(outs)
            names_lit = repr(tuple(outs))

        ret_tuple = "(" + ", ".join(outs) + ("," if len(outs) == 1 else "") \
            + ")" if outs else "()"
        target = ret_tuple if outs else "_pt_void_%d" % i
        src = (
            f"def _pt_t_{i}({arglist}):\n"
            f"{_indent(node.body)}\n"
            f"    return {ret_tuple}\n"
            f"def _pt_f_{i}({arglist}):\n"
            f"{_indent(node.orelse)}\n"
            f"    return {ret_tuple}\n"
            f"{target} = _jst.convert_ifelse(({test_src}), _pt_t_{i}, "
            f"_pt_f_{i}, {names_lit}, locals())\n"
        )
        return _parse_stmts(src) + post

    # -- loops --------------------------------------------------------
    def _build_while(self, i, test_src, body_stmts, init_src, outs):
        arglist = ", ".join(outs)
        names_lit = repr(tuple(outs))
        ret_tuple = "(" + ", ".join(outs) + ("," if len(outs) == 1 else "") \
            + ")"
        src = (
            (init_src + "\n" if init_src else "")
            + f"def _pt_wc_{i}({arglist}):\n"
            f"    return ({test_src})\n"
            f"def _pt_wb_{i}({arglist}):\n"
            f"{_indent(body_stmts)}\n"
            f"    return {ret_tuple}\n"
            f"{ret_tuple} = _jst.convert_while_loop(_pt_wc_{i}, "
            f"_pt_wb_{i}, {names_lit}, locals())\n"
        )
        return _parse_stmts(src)

    def visit_While(self, node):
        if node.orelse:
            raise NotImplementedError(
                "to_static does not support while/else")
        if _contains_return(node.body):
            raise NotImplementedError(
                "to_static does not support `return` inside a converted "
                "while loop body; assign to a variable and return after "
                "the loop")
        i = self._next()
        rw = _BreakContinueRewriter(i)
        body, _ = rw.rewrite(node.body)
        test_src = ast.unparse(node.test)
        init = []
        if rw.brk_used:
            init.append(f"{rw.brk} = False")
            test_src = (f"_jst.convert_logical_and(lambda: "
                        f"_jst.convert_logical_not({rw.brk}), "
                        f"lambda: ({test_src}))")
        if rw.cont_used:
            init.append(f"{rw.cont} = False")
            body = _parse_stmts(f"{rw.cont} = False") + body

        # convert nested constructs (incl. the guards just created)
        wrapper = ast.Module(body=body, type_ignores=[])
        wrapper = self.generic_visit(wrapper)
        body = wrapper.body
        test_node = ast.parse(test_src, mode="eval").body
        test_node = self.visit(test_node)
        test_src = ast.unparse(test_node)

        outs = _user_names(_assigned_names(body))
        if not outs:
            raise NotImplementedError(
                "converted while loop assigns no variables; a loop whose "
                "body has only side effects cannot become a static op")
        return self._build_while(i, test_src, body, "\n".join(init), outs)

    def visit_For(self, node):
        if node.orelse:
            raise NotImplementedError("to_static does not support for/else")
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range"):
            # tensors iterate as their rows (convert_iterable unrolls a
            # static leading dim); python containers pass through.
            # Either way the loop stays a python loop whose body still
            # converts (tensor ifs must not bake).  A raw
            # break/continue cannot move into a generated branch
            # function (SyntaxError), so rewrite them into flags first
            # and emit REAL break/continue at the loop-body top level,
            # guarded by the (possibly tensor-valued) flags.
            node.iter = ast.parse(
                f"_jst.convert_iterable({ast.unparse(it)})",
                mode="eval").body
            if _contains_break_or_continue(node.body):
                i = self._next()
                rw = _BreakContinueRewriter(i)
                body, _ = rw.rewrite(node.body)
                wrapper = ast.Module(body=body, type_ignores=[])
                wrapper = self.generic_visit(wrapper)
                body = wrapper.body
                pre = []
                if rw.cont_used:
                    body = _parse_stmts(f"{rw.cont} = False") + body
                if rw.brk_used:
                    pre.append(f"{rw.brk} = False")
                    body = body + _parse_stmts(
                        f"if _jst.to_bool({rw.brk}):\n    break")
                node.body = body
                init = _parse_stmts("\n".join(pre)) if pre else []
                return init + [node]
            self.generic_visit(node)
            return node
        if not isinstance(node.target, ast.Name):
            raise NotImplementedError(
                "to_static for-range needs a simple loop variable")
        if _contains_return(node.body):
            raise NotImplementedError(
                "to_static does not support `return` inside a converted "
                "for-range loop body; assign to a variable and return "
                "after the loop")
        i = self._next()
        var = node.target.id
        a = [ast.unparse(x) for x in it.args]
        if len(a) == 1:
            start, stop, step = "0", a[0], "1"
        elif len(a) == 2:
            start, stop, step = a[0], a[1], "1"
        else:
            start, stop, step = a[0], a[1], a[2]

        rw = _BreakContinueRewriter(i)
        body, _ = rw.rewrite(node.body)
        # python for semantics: the loop variable holds the CURRENT
        # iteration's value (and keeps it after break/exhaustion), so an
        # internal iterator carries the next position and the loop var is
        # assigned at body start
        it = f"_pt_it_{i}"
        init = [f"{var} = _jst.init_loop_var(locals(), {var!r}, ({start}))",
                f"{it} = {start}",
                f"_pt_lim_{i} = {stop}", f"_pt_step_{i} = {step}"]
        test_src = f"_jst.range_cond({it}, _pt_lim_{i}, _pt_step_{i})"
        if rw.brk_used:
            init.append(f"{rw.brk} = False")
            test_src = (f"_jst.convert_logical_and(lambda: "
                        f"_jst.convert_logical_not({rw.brk}), "
                        f"lambda: ({test_src}))")
        if rw.cont_used:
            init.append(f"{rw.cont} = False")
            body = _parse_stmts(f"{rw.cont} = False") + body
        body = _parse_stmts(f"{var} = {it}\n"
                            f"{it} = {it} + _pt_step_{i}") + body

        wrapper = ast.Module(body=body, type_ignores=[])
        wrapper = self.generic_visit(wrapper)
        body = wrapper.body

        outs = _user_names(_assigned_names(body) + [var])
        outs = sorted(set(outs) | {it, f"_pt_lim_{i}", f"_pt_step_{i}"})
        return self._build_while(i, test_src, body, "\n".join(init), outs)


def convert_callable(obj):
    """Entry point used by the trace machinery: functions and bound
    methods convert directly; Layer-like objects convert their
    ``forward`` (reference StaticFunction over Layer.forward) while
    still dispatching through ``__call__`` so forward pre/post hooks
    keep running.  What this function returned passes through as it is
    (``StaticFunction`` converts at construction and ``trace`` again: a
    second pass over the Layer's dispatch wrapper would reject its
    ``try``/``finally``)."""
    if hasattr(obj, "__wrapped_original__"):
        return obj
    if inspect.isfunction(obj) or inspect.ismethod(obj):
        return convert_to_static(obj)
    fwd = getattr(obj, "forward", None)
    if fwd is not None and inspect.ismethod(fwd):
        conv = convert_to_static(fwd)
        if conv is not fwd:
            def call(*a, **k):
                obj.forward = conv  # instance attr shadows the method
                try:
                    return obj(*a, **k)
                finally:
                    del obj.forward

            call.__wrapped_original__ = obj
            return call
    return obj


def convert_to_static(fn):
    """Rewrite fn's AST; returns the converted function (or fn itself if
    the source is unavailable, e.g. a builtin or REPL lambda)."""
    base = fn
    bound_self = getattr(fn, "__self__", None)
    if bound_self is not None:
        base = fn.__func__
    try:
        src = textwrap.dedent(inspect.getsource(base))
    except (OSError, TypeError):
        return fn
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    fdef.decorator_list = []  # strip @to_static etc. (reference does too)
    if _contains_return(fdef.body) and not _legacy_return_ok(fdef.body):
        _ReturnRewriter().rewrite_function(fdef)
    _Dy2StaticTransformer().visit(fdef)
    ast.fix_missing_locations(tree)

    glb = dict(base.__globals__)
    if base.__closure__:
        glb.update(zip(base.__code__.co_freevars,
                       (c.cell_contents for c in base.__closure__)))
    glb["_jst"] = sys.modules[__name__]
    code = compile(tree, filename=f"<to_static {base.__name__}>",
                   mode="exec")
    ns: dict = {}
    exec(code, glb, ns)
    out = ns[fdef.name]
    out.__wrapped_original__ = fn
    if bound_self is not None:
        out = out.__get__(bound_self)
    return out
