"""AdamW's global-norm clip and update over a model's leaves: two
multi-tensor CUDA passes (`kernel.cu`), their wrapper (`ops.py`) and the
plain per-leaf formula (`ref.py`)."""
