"""Container I/O: BMP in, JFIF out."""
