"""Training of the fixture towers (counterpart of holoagent_tpu/training):
so far only the fixture vocabulary."""
