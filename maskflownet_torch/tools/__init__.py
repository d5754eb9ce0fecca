"""Command-line tools of the port, and the host-side tools of the JAX
package it copies: ``flow_vis`` (the flow colour wheel) and ``submission``
(the Sintel and KITTI benchmark files)."""

from maskflownet_torch.tools import flow_vis, submission

__all__ = ["flow_vis", "submission"]
