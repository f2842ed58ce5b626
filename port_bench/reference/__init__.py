"""Plain fp32 PyTorch references of the benchmark's models: OpenAI CLIP's
ViT and text tower, timm's EVA01 ViT, open_clip's contrastive losses and
torch's AdamW equations written out. No kernels, no cache, no batching
tricks, and nothing of the port: the benchmark hands the same seeded
weights and inputs to both sides and judges the port's outputs here."""
