"""The reading of metrics/memory_read_roofline.stream.py, for the trimap stream,
whose frames/s has a bound of its own (stream_fps.trimap)."""
import os
import runpy

HERE = os.path.dirname(os.path.abspath(__file__))
read = runpy.run_path(os.path.join(HERE, "memory_read_roofline.stream.py"))["read"]
