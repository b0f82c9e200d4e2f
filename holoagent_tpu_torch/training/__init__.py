"""Training (counterpart of holoagent_tpu/training): contrastive CLIP
training, the fixture-tower zoo and VLM distillation, on one device."""

from .contrastive import clip_loss, init_train_state, make_train_step
from .distill import distill_step, distill_vlm
