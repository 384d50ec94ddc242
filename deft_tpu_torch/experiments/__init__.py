"""Experiments of the port: counterparts of deft_tpu's experiments/ that run
on the card (kernel_lab: the flatten kernel lab)."""
