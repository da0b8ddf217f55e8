"""dy2static of the port (`paddle_tpu_torch.jit.dy2static`) against the
JAX package's: each of the 21 cases of `tests/test_dy2static.py` runs
through both packages' `to_static` (the JAX package traces it under
jax.jit; the port runs it eagerly, or records it under a static Program,
or exports it with torch.export), and the outputs agree exactly with
each other and with eager Python. Then `jit.save` / `jit.load` of a
layer whose forward branches and loops on tensor values (torch.cond and
while_loop in the saved program), in both branches, on the CPU."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.jit import dy2static as jdy
from paddle_tpu_torch.jit import dy2static as tdy

from torch_static_parity import on_the_cpu, port_exe  # noqa: F401


def _t(P, a):
    return P.to_tensor(np.asarray(a, dtype="float32"))


def _n(P, v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _dy(P):
    return jdy if P is J else tdy


def case_data_dependent_if(P):
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y
    sf = P.jit.to_static(f)
    return [_n(P, sf(_t(P, a))) for a in ([1.0, 2.0], [-3.0, -4.0])]


def case_if_both_branches_return(P):
    def f(x):
        if x.mean() > 1.0:
            return x * 10.0
        else:
            return x + 100.0
    sf = P.jit.to_static(f)
    return [_n(P, sf(_t(P, [5.0]))), _n(P, sf(_t(P, [0.0])))]


def case_data_dependent_while(P):
    def f(x):
        s = x
        while s.sum() < 100.0:
            s = s * 2.0
        return s
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0, 2.0])))]


def case_for_over_tensor_range(P):
    def f(x, n):
        acc = x * 0.0
        for i in range(n):
            acc = acc + x + (i * 0.0)
        return acc
    n = P.to_tensor(np.asarray(4, dtype="int32"))
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0, 3.0]), n))]


def case_static_for_stays_python(P):
    def f(x):
        acc = x
        for i in range(3):
            acc = acc + 1.0
        return acc
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0])))]


def case_bool_ops_on_tensors(P):
    def f(x):
        if (x.sum() > 0.0) and (x.mean() < 10.0):
            return x + 1.0
        else:
            return x - 1.0
    sf = P.jit.to_static(f)
    return [_n(P, sf(_t(P, a))) for a in ([1.0], [-1.0], [50.0])]


def case_python_bool_short_circuit_preserved(P):
    calls = []

    def g():
        calls.append(1)
        return True

    def f(flag):
        return bool(flag and g())
    tf = _dy(P).ast_transform(f)
    out = [tf(False), list(calls), tf(True), list(calls)]
    assert out == [False, [], True, [1]]
    return [np.asarray(out[0]), np.asarray(out[2])]


def case_nested_if_in_layer_forward(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                h = h * 2.0
            else:
                h = h * 0.5
            return h
    P.seed(3)
    net = Net()
    x = _t(P, np.ones((2, 4)))
    eager = _n(P, net(x))
    net.forward = P.jit.to_static(net.forward)
    np.testing.assert_allclose(_n(P, net(x)), eager, rtol=1e-6)
    return None   # the weights differ between packages


def case_program_translator_disable(P):
    d = _dy(P)
    d.ProgramTranslator().enable(False)
    try:
        def f(x):
            return x * 1.0
        assert d.ast_transform(f) is f
    finally:
        d.enable_to_static(True)
    assert d.ProgramTranslator().enable_to_static
    return None


def case_ternary_expression(P):
    def f(x):
        y = x * 2.0 if x.sum() > 0 else x * -1.0
        return y
    sf = P.jit.to_static(f)
    return [_n(P, sf(_t(P, a))) for a in ([1.0, 2.0], [-1.0, -2.0])]


def case_static_for_loop_var_value_after_loop(P):
    def f(x):
        i = -1.0
        for i in range(3):
            x = x + 1.0
        return x + i
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0])))]


def case_empty_static_range_leaves_loop_var_untouched(P):
    def f(x):
        i = 7.0
        for i in range(0):
            x = x + 100.0
        return x + i
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0])))]


def case_traced_for_loop_var_no_overshoot(P):
    def g(x, n):
        i = 0
        for i in range(n):
            x = x + 0.0
        return x * 0.0 + i
    n = P.to_tensor(np.asarray(4, dtype="int32"))
    return [_n(P, P.jit.to_static(g)(_t(P, [1.0]), n))]


def case_zero_arg_super_in_transformed_method(P):
    class Base(P.nn.Layer):
        def forward(self, x):
            return x + 1.0

    class Child(Base):
        def forward(self, x):
            y = super().forward(x)
            if y.sum() > 0:
                y = y * 2.0
            return y
    net = Child()
    x = _t(P, [1.0, 2.0])
    eager = _n(P, net(x))
    net.forward = P.jit.to_static(net.forward)
    return [_n(P, net(x)), eager]


def case_closure_freevar_in_transformed_fn(P):
    scale = _t(P, [3.0])

    def f(x):
        if x.sum() > 0:
            y = x * scale
        else:
            y = x
        return y
    return [_n(P, P.jit.to_static(f)(_t(P, [2.0])))]


def case_comprehension_in_branch_not_carried(P):
    def f(x):
        if x.sum() > 0:
            parts = [x * float(k) for k in range(1, 3)]
            y = parts[0] + parts[1]
        else:
            y = x
        return y
    sf = P.jit.to_static(f)
    return [_n(P, sf(_t(P, a))) for a in ([1.0], [-1.0])]


def case_zero_arg_super_inside_converted_branch(P):
    class Base2(P.nn.Layer):
        def forward(self, x):
            return x + 1.0

    class Child2(Base2):
        def forward(self, x):
            if x.sum() > 0:
                y = super().forward(x)
            else:
                y = x * 0.0
            return y
    net = Child2()
    xs = [_t(P, [1.0, 2.0]), _t(P, [-1.0, -2.0])]
    eager = [_n(P, net(x)) for x in xs]
    net.forward = P.jit.to_static(net.forward)
    return [_n(P, net(x)) for x in xs] + eager


def case_walrus_in_comprehension_is_carried(P):
    def f(x):
        if x.sum() > 0:
            parts = [(y := x * float(k)) for k in range(1, 3)]
            out = parts[0] + parts[1]
        else:
            y = x
            out = x
        return out + y
    sf = P.jit.to_static(f)
    return [_n(P, sf(_t(P, a))) for a in ([1.0], [-1.0])]


def case_traced_for_prebound_float_loop_var(P):
    def f(x, n):
        i = 0.5
        for i in range(n):
            x = x + 1.0
        return x + i
    n = P.to_tensor(np.asarray(3, dtype="int32"))
    return [_n(P, P.jit.to_static(f)(_t(P, [0.0]), n))]


def case_empty_traced_range_restores_prebound_loop_var(P):
    def f(x, n):
        i = 0.5
        for i in range(n):
            x = x + 1.0
        return x + i
    n0 = P.to_tensor(np.asarray(0, dtype="int32"))
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0]), n0))]


def case_return_inside_loop_falls_back_to_python(P):
    def f(x):
        for i in range(3):
            return x + float(i)
        return x * 100.0

    def g(x):
        while True:
            return x * 2.0
    return [_n(P, P.jit.to_static(f)(_t(P, [1.0]))),
            _n(P, P.jit.to_static(g)(_t(P, [1.0])))]


# each case's expected outputs (tests/test_dy2static.py's asserts)
EXPECTED = {
    "data_dependent_if": [[2.0, 4.0], [-4.0, -5.0]],
    "if_both_branches_return": [[50.0], [100.0]],
    "data_dependent_while": [[64.0, 128.0]],
    "for_over_tensor_range": [[4.0, 12.0]],
    "static_for_stays_python": [[4.0]],
    "bool_ops_on_tensors": [[2.0], [-2.0], [49.0]],
    "ternary_expression": [[2.0, 4.0], [1.0, 2.0]],
    "static_for_loop_var_value_after_loop": [[6.0]],
    "empty_static_range_leaves_loop_var_untouched": [[8.0]],
    "traced_for_loop_var_no_overshoot": [[3.0]],
    "zero_arg_super_in_transformed_method": [[4.0, 6.0], [4.0, 6.0]],
    "closure_freevar_in_transformed_fn": [[6.0]],
    "comprehension_in_branch_not_carried": [[3.0], [-1.0]],
    "zero_arg_super_inside_converted_branch": [[2.0, 3.0], [0.0, 0.0],
                                               [2.0, 3.0], [0.0, 0.0]],
    "walrus_in_comprehension_is_carried": [[5.0], [-2.0]],
    "traced_for_prebound_float_loop_var": [[5.0]],
    "empty_traced_range_restores_prebound_loop_var": [[1.5]],
    "return_inside_loop_falls_back_to_python": [[1.0], [2.0]],
}
CASES = sorted(n[len("case_"):] for n in dir() if n.startswith("case_"))


def test_all_21_cases_listed():
    assert len(CASES) == 21


@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax(name):
    fn = globals()["case_" + name]
    got, want = fn(T), fn(J)
    if got is None:
        assert want is None
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.astype(np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=1e-6)
    if name in EXPECTED:
        for g, e in zip(got, EXPECTED[name]):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(e, np.float64), atol=1e-6)


# -- traced paths of the port ---------------------------------------------------

class _Gate(T.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = T.nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        if h.mean() > 0:
            h = h * 2.0
        else:
            h = h - 1.0
        while h.abs().sum() < 1000.0:
            h = h * 1.5
        return h


def test_jit_save_load_tensor_if_both_branches(tmp_path):
    """A to_static layer branching and looping on tensor values saves
    (torch.cond and while_loop in the program) and loads on the CPU
    equal to eager on inputs taking each branch."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec
    torch.manual_seed(0)
    layer = _Gate()
    xs = [torch.full((2, 4), s) for s in (-3.0, 3.0)]
    with torch.no_grad():
        eager = [layer(x) for x in xs]
        taken = {bool(layer.fc(x).mean() > 0) for x in xs}
    assert taken == {True, False}
    jit.save(jit.to_static(layer), str(tmp_path / "gate"),
             input_spec=[InputSpec([2, 4], "float32")])
    loaded = jit.load(str(tmp_path / "gate"), device="cpu")
    hops = {getattr(nd.target, "__name__", "") for nd in
            loaded._exported.graph.nodes if nd.op == "call_function"}
    assert {"cond", "while_loop"} <= hops
    for x, e in zip(xs, eager):
        np.testing.assert_allclose(loaded(x).numpy(), e.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_exported_for_range_and_bool_ops():
    """A traced `for i in range(n)` (while_loop over the trip count,
    the loop variable never overshooting) and `and` on traced values,
    exported, equal eager Python at n = 0 and n = 3."""
    def f(x, n):
        i = 0.5
        for i in range(n):
            x = x + 1.0
        if (x.sum() > 0) and (x.mean() < 10.0):
            x = x + i
        return x

    sf = T.jit.to_static(f)

    class M(torch.nn.Module):
        def forward(self, x, n):
            return sf(x, n)
    ep = torch.export.export(M(), (torch.ones(2), torch.tensor(3)))
    for n in (0, 3):
        np.testing.assert_allclose(
            ep.module()(torch.ones(2), torch.tensor(n)).numpy(),
            f(torch.ones(2), n).numpy())


def test_to_static_under_program_guard_records_cond():
    """Called on static Variables, a to_static function records a `cond`
    op (and a `while` op) with sub-blocks; the Executor follows the
    feed into either branch."""
    from paddle_tpu_torch import static
    T.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main, static.Program()):
            x = static.data("x", [3], "float32")

            @T.jit.to_static
            def f(v):
                if v.sum() > 0:
                    v = v * 2.0
                else:
                    v = v - 1.0
                while v.abs().sum() < 50.0:
                    v = v * 3.0
                return v
            out = f(x)
        kinds = [op.type for op in main.ops]
        assert "cond" in kinds and "while" in kinds
        exe = port_exe()
        for s in (1.0, -1.0):
            xv = np.full(3, s, "float32")
            got = exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
            ref = xv * 2 if s > 0 else xv - 1
            while np.abs(ref).sum() < 50.0:
                ref = ref * 3
            np.testing.assert_allclose(got, ref)
    finally:
        T.disable_static()
