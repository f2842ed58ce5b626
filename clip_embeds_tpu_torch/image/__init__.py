"""Host image decode and preprocessing (PIL, and the native C++ pipeline
with a threaded prefetch loader)."""
