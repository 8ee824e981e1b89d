"""The port's native-format helpers. So far the pure-Python recordio
writer and reader (``recordio.py``), byte-compatible with the JAX
package's ``paddle_tpu/native/recordio.py``. The ctypes bindings over
``csrc/*.cc`` (recordio, memory, channel) are not ported yet."""
