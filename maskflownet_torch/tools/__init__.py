"""Command-line tools of the port, and the host-side tools of the JAX
package it copies: ``flow_vis`` (the flow colour wheel) and ``submission``
(the Sintel and KITTI benchmark files).

The command-line modules (``import_mxnet``, ``infer``, ``parity_eval``,
the probes) are imported by name, never here: ``python -m
maskflownet_torch.tools.infer`` would otherwise find its module already
loaded by the package and warn."""

from maskflownet_torch.tools import flow_vis, submission

__all__ = ["flow_vis", "submission"]
