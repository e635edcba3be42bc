"""Columnar batches of whole M3TSZ streams (port of ``m3_tpu/segment``)."""
