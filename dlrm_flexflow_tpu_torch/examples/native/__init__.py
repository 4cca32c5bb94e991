"""Native-API example applications (``python -m
dlrm_flexflow_tpu_torch.examples.native.<name>``)."""
