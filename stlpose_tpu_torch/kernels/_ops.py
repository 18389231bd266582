"""The ``stlpose`` operator library: the serving kernels as PyTorch
operators.

Each serving kernel's wrapper calls its operator, ``torch.ops.stlpose.
<name>``, which dispatches by the device of its tensors: the CPU
implementation is the kernel's plain version, the CUDA implementation
builds (at first use) and launches the kernel and counts the launch, and
a fake implementation gives the output shapes and dtypes from the input
shapes alone (a symbolic batch included) and touches no data. So
``torch.export`` records each kernel as one node of the graph, a saved
program needs only this package's kernel modules to load, and it runs
the kernels on the card and the plain versions on the CPU.

The operators are defined with ``torch.library.Library`` and ``impl``,
whose dispatch costs a few microseconds a call less than
``torch.library.custom_op``'s wrapper; an eager call skips the
dispatcher altogether (``Operator``).
"""

from __future__ import annotations

import torch

NAMESPACE = "stlpose"
LIB = torch.library.Library(NAMESPACE, "DEF")
OPERATORS: dict = {}          # name -> Operator, filled by define()


class Operator:
    """An ``stlpose`` operator as its wrapper calls it: ``op(*args)``.

    Traced (``torch.export``, ``torch.compile``, fake tensors: a tensor
    subclass or a dispatch mode is in play), the call goes through the
    dispatcher and is recorded as one node of the graph. An eager call on
    plain tensors goes straight to the implementation of its tensors'
    device, the function the dispatcher would call: the dispatcher's
    argument conversion costs ~4-8 µs a call (measured on the CPU for
    these schemas, more on the card's host), and HRNet-W32 int8 makes
    ~550 kernel calls a forward. Either way the same implementation runs
    and counts the launch."""

    def __init__(self, overload, cpu, cuda):
        self.overload = overload
        self.impls = {"cpu": cpu, "cuda": cuda}
        self.__name__ = overload._opname

    def __call__(self, *args):
        """Run the operator on ``args`` (its schema's arguments, in order).
        Raises ``ValueError`` for a tensor neither on the CPU nor on a
        CUDA device: a fake implementation would answer a meta tensor."""
        lead = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
        impl = self.impls.get(lead.device.type)
        if impl is None:
            raise ValueError(f"{self.__name__}: expected a CPU or CUDA "
                             f"tensor, got one on {lead.device}")
        if (type(lead) is torch.Tensor
                and not torch._C._len_torch_dispatch_stack()
                and not torch.compiler.is_compiling()):
            return impl(*args)
        return self.overload(*args)


def define(schema: str, cpu, cuda, fake) -> Operator:
    """Define operator ``schema`` (``"name(args) -> outputs"``) with its
    CPU, CUDA and fake implementations; returns it as an ``Operator``."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    OPERATORS[name] = Operator(
        getattr(getattr(torch.ops, NAMESPACE), name).default, cpu, cuda)
    return OPERATORS[name]


def operator_of(target):
    """The ``Operator`` of an FX node's target if it is an ``stlpose``
    operator's overload, else None."""
    if (isinstance(target, torch._ops.OpOverload)
            and target.namespace == NAMESPACE):
        return OPERATORS.get(target._opname)
    return None


def operator_names(graph) -> list[str]:
    """Sorted names of the ``stlpose`` operators that the nodes of an
    FX ``graph`` call."""
    return sorted({node.target._opname for node in graph.nodes
                   if node.op == "call_function"
                   and operator_of(node.target) is not None})
