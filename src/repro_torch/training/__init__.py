"""Training of the port (mirrors `repro.training`): the reference's AdamW
with f32 master weights, its training step and flat-npz checkpoints, on
torch tensors."""
