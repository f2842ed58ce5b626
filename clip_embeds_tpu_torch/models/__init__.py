"""CLIP towers, composable and fused serving paths."""
