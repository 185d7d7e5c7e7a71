"""Host-side native code of the port (C ABI over ctypes, built with g++)."""
