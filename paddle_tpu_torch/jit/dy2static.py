"""Dygraph->static AST transpiler (port of `paddle_tpu.jit.dy2static`;
reference `fluid/dygraph/dygraph_to_static/` — `ast_transformer.py`,
`convert_operators.py`, `program_translator.py:756 ProgramTranslator`).

The reference rewrites Python source so data-dependent control flow
becomes graph ops (`while_op`, `conditional_block_op`). As in the JAX
package, the same constructs are rewritten into runtime-dispatched
converter calls, which decide by the predicate:

  * a traced value, i.e. a fake tensor of a `torch.export` trace (what
    `jit.save` traces): ``if``/ternary -> `torch.cond`, ``while`` and
    ``for i in range(traced_n)`` -> `torch._higher_order_ops.while_loop`;
  * a Variable of a static Program being recorded (`program_guard`):
    ``if`` -> a recorded `cond` op, ``while``/``for`` -> a recorded
    `while` op, each with its sub-blocks (`static.nn`);
  * anything else (a concrete tensor, a Python value): plain Python.

``and`` / ``or`` / ``not`` on traced values or Variables become
`logical_and/or/not`. The AST rewrite itself (`Dy2StaticTransformer`,
`_RewriteZeroArgSuper`, `ast_transform`) is the JAX package's, which is
pure Python.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap

import torch
from torch.utils import _pytree as pytree

from ..framework import static_hook

__all__ = ["ast_transform", "ProgramTranslator", "enable_to_static",
           "convert_ifelse", "convert_while", "convert_for_range",
           "convert_bool_op", "convert_not", "Dy2StaticTransformer"]

_ENABLED = True


def enable_to_static(flag=True):
    global _ENABLED
    _ENABLED = bool(flag)


class ProgramTranslator:
    """reference `program_translator.py:756` — global on/off switch."""
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def enable(self, flag):
        enable_to_static(flag)

    @property
    def enable_to_static(self):
        return _ENABLED


# ---------------------------------------------------------------------------
# runtime converters
# ---------------------------------------------------------------------------

def _kind(x):
    """"export" for a fake tensor of a `torch.export` trace, "static" for
    a Variable of a Program being recorded, else None (run Python)."""
    if not torch.is_tensor(x):
        return None
    from ..static.nn import _traced
    if _traced(x):
        return "export"
    if static_hook.recording() and getattr(x, "slot", None) is not None:
        return "static"
    return None


class _Undefined:
    """Placeholder for names not yet bound before a branch/loop assigns
    them (reference `dygraph_to_static/utils.py` UndefinedVar)."""

    def __repr__(self):
        return "<dy2static undefined>"


UNDEF = _Undefined()


def _is_undef(x):
    return isinstance(x, _Undefined)


def _pred(p):
    return p.reshape(()).to(torch.bool)


def _tensorize(v, like=None):
    """A value carried through torch.cond / while_loop: a tensor."""
    if torch.is_tensor(v):
        return v
    dev = like.device if torch.is_tensor(like) else None
    return torch.as_tensor(v, device=dev)


def convert_ifelse(pred, true_fn, false_fn, init=(), single=None):
    """`if` with runtime dispatch (reference convert_ifelse). Branch fns
    receive `init` (the pre-branch values of every name either branch
    assigns) so rebinding inside them never shadows the closure.

    ``single`` marks init slots whose name is assigned in only ONE
    branch. When such a name is also unbound before the `if`, the two
    branches would return mismatched structures under a traced cond —
    those slots stay branch-local and undefined after the if, matching
    Python's untaken-branch behaviour."""
    kind = _kind(pred)
    if kind is None:
        return true_fn(init) if pred else false_fn(init)
    init = tuple(init)
    single = tuple(single) if single is not None else (False,) * len(init)
    dropped = {j for j in range(len(init))
               if single[j] and _is_undef(init[j])}
    leaves, spec = pytree.tree_flatten(init)
    idx = [i for i, l in enumerate(leaves)
           if torch.is_tensor(l) and not _is_undef(l)]

    def runner(fn):
        def run(*op_leaves):
            ls = list(leaves)
            for i, v in zip(idx, op_leaves):
                ls[i] = v
            out = fn(pytree.tree_unflatten(ls, spec))
            if dropped:
                out = tuple(0 if j in dropped else v
                            for j, v in enumerate(tuple(out)))
            # a traced cond's branch may not hand back an operand itself
            return tuple(
                v.clone() if any(v is o for o in op_leaves) else
                _tensorize(v, pred) for v in out)
        return run

    if kind == "static":
        from ..static.nn import cond
        out = cond(pred, lambda: runner(true_fn)(*[leaves[i] for i in idx]),
                   lambda: runner(false_fn)(*[leaves[i] for i in idx]))
    else:
        out = torch.cond(_pred(pred), runner(true_fn), runner(false_fn),
                         tuple(leaves[i] for i in idx))
    if dropped:
        out = tuple(UNDEF if j in dropped else v
                    for j, v in enumerate(tuple(out)))
    return out


def _no_undef_carry(init, what):
    if any(_is_undef(l) for l in pytree.tree_leaves(init)):
        raise ValueError(
            f"dy2static: a variable assigned only inside a traced {what} "
            "cannot be loop-carried — initialize it before the loop (a "
            "traced while_loop needs a fixed carry)")


def convert_while(cond_fn, body_fn, init):
    """`while` with runtime dispatch (reference convert_while_loop)."""
    c = cond_fn(init)
    kind = _kind(c)
    if kind is None:
        vars_ = init
        while True:
            if not bool(cond_fn(vars_)):
                return vars_
            vars_ = body_fn(vars_)
    _no_undef_carry(init, "`while`/`for`")
    leaves, spec = pytree.tree_flatten(tuple(init))
    leaves = [_tensorize(l, c) for l in leaves]

    def cond_w(*carry):
        return _pred(_tensorize(cond_fn(pytree.tree_unflatten(
            list(carry), spec))))

    def body_w(*carry):
        out = body_fn(pytree.tree_unflatten(list(carry), spec))
        return tuple(_tensorize(v, c) for v in pytree.tree_leaves(out))
    if kind == "static":
        from ..static.nn import while_loop
        out = while_loop(cond_w, body_w, leaves)
    else:
        from torch._higher_order_ops.while_loop import while_loop
        out = while_loop(cond_w, body_w, tuple(leaves))
    return pytree.tree_unflatten(list(out), spec)


def _logical(op, a, b):
    a = _tensorize(a).to(torch.bool)
    b = _tensorize(b, a).to(torch.bool)
    return torch.logical_and(a, b) if op == "and" else \
        torch.logical_or(a, b)


def convert_bool_op(op, *operand_fns):
    """`and`/`or` preserving python short-circuit for concrete values and
    lowering to elementwise logical ops for traced ones."""
    val = operand_fns[0]()
    for f in operand_fns[1:]:
        if _kind(val) is not None:
            val = _logical(op, val, f())
        elif op == "and":
            if not val:
                return val
            val = f()
        else:
            if val:
                return val
            val = f()
    return val


def convert_not(x):
    if _kind(x) is not None:
        return torch.logical_not(x.to(torch.bool))
    return not x


def convert_for_range(start, stop, step, body_fn, init):
    """``for i in range(...)`` with runtime dispatch. The loop variable is
    element 0 of ``init`` and of the carry ``body_fn`` receives/returns.

    Concrete bounds run a plain Python ``for`` (exact CPython semantics:
    the loop variable keeps its last-iterated value, an empty range
    leaves it untouched). Traced bounds lower to a while loop over a
    precomputed trip count, with the loop variable reconstructed as
    ``start + k*step`` — never the post-loop overshoot value."""
    init = tuple(init)
    kinds = [_kind(v) for v in (start, stop, step)]
    kind = "export" if "export" in kinds else \
        "static" if "static" in kinds else None
    if kind is None:
        vars_ = init
        for iv in range(int(start), int(stop), int(step)):
            vars_ = tuple(body_fn((iv,) + tuple(vars_[1:])))
        return vars_
    _no_undef_carry(list(init[1:]), "`for`")
    like = next(v for v in (start, stop, step) if torch.is_tensor(v))
    start_a = _tensorize(start, like)
    if start_a.is_floating_point() or start_a.dtype == torch.bool:
        start_a = start_a.to(torch.int32)
    stop_a = _tensorize(stop, like).to(start_a.dtype)
    step_a = _tensorize(step, like).to(start_a.dtype)
    # integer ceil-division trip count: ceil((stop-start)/step) ==
    # -((start-stop)//step); step == 0 (ValueError in CPython) runs no
    # iteration
    safe_step = torch.where(step_a == 0, torch.ones_like(step_a), step_a)
    n_iter = torch.where(
        step_a == 0, torch.zeros_like(step_a),
        torch.clamp(-torch.div(start_a - stop_a, safe_step,
                               rounding_mode="floor"), min=0))
    # the loop-var carry slot takes the range's type; a pre-bound value
    # is restored after the loop for the n_iter == 0 case
    i0 = start_a if _is_undef(init[0]) else \
        _tensorize(init[0], like).to(start_a.dtype)
    rest, spec = pytree.tree_flatten(tuple(init[1:]))
    rest = [_tensorize(v, like) for v in rest]
    k0 = torch.zeros((), dtype=torch.int32, device=like.device)

    def cond_w(k, iv, *vals):
        return k < n_iter.to(k.dtype).reshape(())

    def body_w(k, iv, *vals):
        cur = (start_a + k.to(start_a.dtype) * step_a).reshape(
            start_a.shape)
        out = tuple(body_fn((cur,) + tuple(pytree.tree_unflatten(
            list(vals), spec))))
        new_rest = [_tensorize(v, like)
                    for v in pytree.tree_leaves(tuple(out[1:]))]
        return (k + 1, _tensorize(out[0], like).to(start_a.dtype),
                *new_rest)
    carry = (k0, i0, *rest)
    if kind == "static":
        from ..static.nn import while_loop
        out = while_loop(cond_w, body_w, list(carry))
    else:
        from torch._higher_order_ops.while_loop import while_loop
        out = while_loop(cond_w, body_w, carry)
    out = list(out)
    loop_var = out[1]
    if not _is_undef(init[0]):
        # an empty traced range leaves the pre-bound loop var untouched
        # (including a non-integer value the carry slot had to truncate)
        orig = _tensorize(init[0], like)
        loop_var = torch.where(n_iter > 0, loop_var.to(orig.dtype), orig)
    return (loop_var,) + tuple(pytree.tree_unflatten(out[2:], spec))


# ---------------------------------------------------------------------------
# static analysis helpers
# ---------------------------------------------------------------------------

_SKIP_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda)
# comprehensions own their iteration targets in py3 — scope boundaries too
_COMPREHENSION_SCOPES = (ast.ListComp, ast.SetComp, ast.DictComp,
                         ast.GeneratorExp)


def _stored_names(stmts):
    """Names assigned at the top scope of `stmts` (nested defs and
    comprehension iteration variables excluded; walrus targets inside
    comprehensions DO bind in the enclosing scope — PEP 572)."""
    out = []

    def walk(node, in_comp=False):
        if isinstance(node, _SKIP_SCOPES):
            return
        if isinstance(node, _COMPREHENSION_SCOPES):
            for child in ast.iter_child_nodes(node):
                walk(child, True)
            return
        if isinstance(node, ast.NamedExpr):
            if (isinstance(node.target, ast.Name)
                    and not node.target.id.startswith("__dy2s")):
                out.append(node.target.id)
            walk(node.value, in_comp)
            return
        if (not in_comp and isinstance(node, ast.Name)
                and isinstance(node.ctx, (ast.Store, ast.Del))):
            if not node.id.startswith("__dy2s"):
                out.append(node.id)
        for child in ast.iter_child_nodes(node):
            walk(child, in_comp)
    for s in stmts:
        walk(s)
    seen, uniq = set(), []
    for n in out:
        if n not in seen:
            seen.add(n)
            uniq.append(n)
    return uniq


def _contains(stmts, types):
    for s in stmts:
        for node in ast.walk(s):
            if isinstance(node, types) and not isinstance(node,
                                                          _SKIP_SCOPES):
                return True
    return False


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _tuple_of(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names],
                     ctx=ctx or ast.Load())


def _jst_attr(fn_name):
    return ast.Attribute(value=_name("_jst"), attr=fn_name, ctx=ast.Load())


def _make_fn(name, args, body):
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(posonlyargs=[], args=[ast.arg(arg=a)
                                                 for a in args],
                           kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=body, decorator_list=[], returns=None, type_params=[])


def _guard(name):
    """`try: name / except NameError: name = _jst.UNDEF` — lets possibly
    unbound names ride the init tuple (reference UndefinedVar filling)."""
    return ast.parse(
        f"try:\n    {name}\nexcept NameError:\n"
        f"    {name} = _jst.UNDEF").body[0]


# ---------------------------------------------------------------------------
# the AST transformer
# ---------------------------------------------------------------------------

class Dy2StaticTransformer(ast.NodeTransformer):
    """One bottom-up pass over a function body (reference splits this into
    14 transformer modules; the converter-dispatch design needs only the
    control-flow and boolean rewrites)."""

    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- boolean operators --------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        op = "and" if isinstance(node.op, ast.And) else "or"
        lambdas = [ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=v) for v in node.values]
        return ast.Call(func=_jst_attr("convert_bool_op"),
                        args=[ast.Constant(value=op)] + lambdas, keywords=[])

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_jst_attr("convert_not"),
                            args=[node.operand], keywords=[])
        return node

    def visit_IfExp(self, node):
        self.generic_visit(node)
        # convert_ifelse always calls branch fns with one arg (the init
        # tuple) — the lambdas must accept and ignore it
        mk = lambda b: ast.Lambda(
            args=ast.arguments(posonlyargs=[],
                               args=[ast.arg(arg="__dy2s_op")],
                               kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=b)
        return ast.Call(func=_jst_attr("convert_ifelse"),
                        args=[node.test, mk(node.body), mk(node.orelse)],
                        keywords=[])

    # -- if / else ----------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        uid = self._uid()
        body, orelse = node.body, node.orelse or [ast.Pass()]

        has_ret_b = _contains(body, ast.Return)
        has_ret_o = _contains(orelse, ast.Return)
        op = f"__dy2s_op_{uid}"
        if has_ret_b or has_ret_o:
            # only the both-branches-end-in-return shape is convertible
            if (has_ret_b and has_ret_o
                    and isinstance(body[-1], ast.Return)
                    and isinstance(orelse[-1], ast.Return)
                    and not _contains(body[:-1], ast.Return)
                    and not _contains(orelse[:-1], ast.Return)):
                tfn = _make_fn(f"__dy2s_true_{uid}", [op],
                               body[:-1] + [ast.Return(
                                   value=body[-1].value
                                   or ast.Constant(value=None))])
                ffn = _make_fn(f"__dy2s_false_{uid}", [op],
                               orelse[:-1] + [ast.Return(
                                   value=orelse[-1].value
                                   or ast.Constant(value=None))])
                call = ast.Call(func=_jst_attr("convert_ifelse"),
                                args=[node.test,
                                      _name(tfn.name), _name(ffn.name)],
                                keywords=[])
                return [tfn, ffn, ast.Return(value=call)]
            return node  # mixed return shape: leave as python `if`

        assigned = _stored_names(body + orelse)
        b_names = set(_stored_names(body))
        o_names = set(_stored_names(orelse))
        single = [(n in b_names) != (n in o_names) for n in assigned]
        ret = lambda: (_tuple_of(assigned) if assigned
                       else ast.Tuple(elts=[], ctx=ast.Load()))
        unpack = lambda: ([ast.Assign(
            targets=[_tuple_of(assigned, ast.Store())],
            value=_name(op))] if assigned else [])
        tfn = _make_fn(f"__dy2s_true_{uid}", [op],
                       unpack() + body + [ast.Return(value=ret())])
        ffn = _make_fn(f"__dy2s_false_{uid}", [op],
                       unpack() + orelse + [ast.Return(value=ret())])
        call = ast.Call(func=_jst_attr("convert_ifelse"),
                        args=[node.test, _name(tfn.name), _name(ffn.name),
                              ret()],
                        keywords=[ast.keyword(
                            arg="single",
                            value=ast.Tuple(
                                elts=[ast.Constant(value=s)
                                      for s in single],
                                ctx=ast.Load()))] if assigned else [])
        guards = [_guard(n) for n in assigned]
        if assigned:
            out = ast.Assign(targets=[_tuple_of(assigned, ast.Store())],
                             value=call)
        else:
            out = ast.Expr(value=call)
        return guards + [tfn, ffn, out]

    # -- while --------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _contains(node.body,
                                    (ast.Break, ast.Continue, ast.Return)):
            return node  # break/continue/return: python-only semantics
        uid = self._uid()
        carried = _stored_names(node.body)
        return self._lower_loop(uid, node.test, node.body, carried)

    def _lower_loop(self, uid, test, body, carried):
        var = f"__dy2s_vars_{uid}"
        unpack = lambda: ([ast.Assign(
            targets=[_tuple_of(carried, ast.Store())],
            value=_name(var))] if carried else [])
        tup = lambda: (_tuple_of(carried) if carried
                       else ast.Tuple(elts=[], ctx=ast.Load()))
        cond_fn = _make_fn(f"__dy2s_cond_{uid}", [var],
                           unpack() + [ast.Return(value=test)])
        body_fn = _make_fn(f"__dy2s_body_{uid}", [var],
                           unpack() + body + [ast.Return(value=tup())])
        call = ast.Call(func=_jst_attr("convert_while"),
                        args=[_name(cond_fn.name), _name(body_fn.name),
                              tup()], keywords=[])
        guards = [_guard(n) for n in carried]
        if carried:
            out = ast.Assign(targets=[_tuple_of(carried, ast.Store())],
                             value=call)
        else:
            out = ast.Expr(value=call)
        return guards + [cond_fn, body_fn, out]

    # -- for i in range(...) -------------------------------------------------
    def visit_For(self, node):
        self.generic_visit(node)
        if (node.orelse
                or _contains(node.body,
                             (ast.Break, ast.Continue, ast.Return))
                or not isinstance(node.target, ast.Name)
                or not (isinstance(node.iter, ast.Call)
                        and isinstance(node.iter.func, ast.Name)
                        and node.iter.func.id == "range"
                        and not node.iter.keywords
                        and 1 <= len(node.iter.args) <= 3)):
            return node
        uid = self._uid()
        a = node.iter.args
        start = a[0] if len(a) >= 2 else ast.Constant(value=0)
        stop = a[1] if len(a) >= 2 else a[0]
        step = a[2] if len(a) == 3 else ast.Constant(value=1)
        i = node.target.id
        # carry layout: loop var first, then everything the body assigns
        carried = [i] + [n for n in _stored_names(node.body) if n != i]
        var = f"__dy2s_vars_{uid}"
        unpack = [ast.Assign(targets=[_tuple_of(carried, ast.Store())],
                             value=_name(var))]
        body_fn = _make_fn(f"__dy2s_body_{uid}", [var],
                           unpack + node.body
                           + [ast.Return(value=_tuple_of(carried))])
        call = ast.Call(func=_jst_attr("convert_for_range"),
                        args=[start, stop, step, _name(body_fn.name),
                              _tuple_of(carried)], keywords=[])
        guards = [_guard(n) for n in carried]
        out = ast.Assign(targets=[_tuple_of(carried, ast.Store())],
                         value=call)
        return guards + [body_fn, out]


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

class _RewriteZeroArgSuper(ast.NodeTransformer):
    """``super()`` → ``super(__class__, self)``.  Zero-arg super() relies
    on the implicit ``__class__`` cell that only class-body-compiled
    functions get; the recompiled function must reference it explicitly
    so it closes over the factory parameter instead."""

    def __init__(self, self_name):
        self._self = self_name

    def _stop(self, node):  # nested scopes have a different `self`
        return node

    visit_FunctionDef = visit_AsyncFunctionDef = _stop
    visit_ClassDef = visit_Lambda = _stop

    def visit_Call(self, node):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Name) and node.func.id == "super"
                and not node.args and not node.keywords):
            node.args = [_name("__class__"), _name(self._self)]
        return node


def ast_transform(fn):
    """Rewrite `fn`'s control flow into converter calls.  Falls back to the
    original function when source is unavailable or the rewrite fails."""
    if not _ENABLED or getattr(fn, "_not_to_static", False):
        return fn
    bound_self = getattr(fn, "__self__", None)
    raw = fn.__func__ if inspect.ismethod(fn) else fn
    if getattr(raw, "__dy2static_transformed__", False):
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(raw))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, ast.FunctionDef):
            return fn
        fdef.decorator_list = []
        freevars = raw.__code__.co_freevars
        # rewrite super() BEFORE control-flow lowering so the explicit
        # super(__class__, self) form rides into generated branch fns
        # (which would otherwise feed their carry tuple as super()'s obj)
        if "__class__" in freevars and fdef.args.args:
            _RewriteZeroArgSuper(fdef.args.args[0].arg).generic_visit(fdef)
        Dy2StaticTransformer().visit(fdef)
        ns = dict(raw.__globals__)
        from . import dy2static as _jst_mod
        ns["_jst"] = _jst_mod
        if freevars:
            # rebuild the closure with real cells: compile the transformed
            # def inside a factory taking every freevar as a parameter
            factory = _make_fn("__dy2s_factory", list(freevars),
                               [fdef, ast.Return(value=_name(fdef.name))])
            tree.body = [factory]
        ast.fix_missing_locations(tree)
        code = compile(tree, filename=f"<dy2static:{raw.__qualname__}>",
                       mode="exec")
        exec(code, ns)
        new_fn = (ns["__dy2s_factory"](*(c.cell_contents
                                         for c in raw.__closure__))
                  if freevars else ns[fdef.name])
    except Exception:
        return fn
    functools.update_wrapper(new_fn, raw)
    new_fn.__dy2static_transformed__ = True
    if bound_self is not None:
        return new_fn.__get__(bound_self, type(bound_self))
    return new_fn
