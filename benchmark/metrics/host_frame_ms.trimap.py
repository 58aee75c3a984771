"""The reading of metrics/host_frame_ms.stream.py, for the trimap stream,
whose frames/s has a bound of its own (stream_fps.trimap)."""
import os
import runpy

HERE = os.path.dirname(os.path.abspath(__file__))
read = runpy.run_path(os.path.join(HERE, "host_frame_ms.stream.py"))["read"]
