"""Eval drivers: What'sUp, COCO/VG-spatial and MMVP (copies of the JAX
package's numpy drivers)."""
