"""The port's command-line entry point, the counterpart of
``maskflownet_tpu.cli``: ``python -m maskflownet_torch.cli.main`` (train,
``--valid``, ``--predict``); its functions are
``maskflownet_torch.cli.main``'s. Nothing is imported here, so that
``python -m`` runs the module once."""
