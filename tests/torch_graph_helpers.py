"""The CPU's stand-in for a CUDA graph, shared by the tests of the graphs
(``tests/test_torch_graphs.py``, ``tests/test_torch_entry_graphs.py``).

A CUDA graph cannot be captured on the CPU, so the graph structure is driven
with :class:`StandIn` in place of ``utils.graphs.Graph``: its first call runs
the function as the warm-up does, every later call runs it under
:class:`NoSync`, a dispatch mode that refuses the operations which copy from
host memory or wait for the device (what a capture would refuse), and, as a
replay does, writes into the outputs of its first later call.
"""

from torch.utils._python_dispatch import TorchDispatchMode

from ergodic_exploration_tpu_torch.utils import graphs


class NoSync(TorchDispatchMode):
    """Refuses the operations that copy from host memory
    (``lift_fresh``) or make the host wait for the device (a scalar read,
    ``nonzero``, ``masked_select``)."""

    REFUSED = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "nonzero",
               "masked_select"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.REFUSED:
            raise AssertionError(f"{func} copies from the host or waits for the device")
        return func(*args, **(kwargs or {}))


class StandIn:
    """A graph's stand-in on the CPU (see the module docstring)."""

    def __init__(self, fn):
        self.fn, self.calls, self.outputs = fn, 0, None

    def __call__(self):
        self.calls += 1
        if self.calls == 1:  # the warm-up
            return self.fn()
        with NoSync():
            out = self.fn()
        if self.outputs is None:
            self.outputs = out
        else:
            graphs.copy_into(self.outputs, out)
        return self.outputs
