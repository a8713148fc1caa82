"""Scripts that measure the port's kernels on the card (run as modules,
``python3 -m lsp_dsp_units_tpu_torch.tools.<name>``)."""
