"""Training on one device: AdamW with f32 master weights, the train step
with microbatch accumulation and int8 gradient compression, the data
pipeline and checkpoints in the reference's on-disk layout."""
