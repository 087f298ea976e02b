"""Evaluation: the RD harness (`python -m opendcvc_tpu_torch.eval.harness`)."""
