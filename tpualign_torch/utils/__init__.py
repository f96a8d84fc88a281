"""Host support of the port: :mod:`tpualign_torch.utils.native`, the
ctypes loader of its C++ (``tpualign_torch/native/bdna_tools.cpp``)."""
