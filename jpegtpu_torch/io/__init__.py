"""Container I/O: BMP in, JFIF out, and the host-card transfers."""
