"""Single-device training of the port: the reference recipe's optimizer,
full-state checkpoints and the step / loop (catseg_tpu/train)."""
