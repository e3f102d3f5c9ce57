"""Per-block transform ops: layout helpers and the K1 transform."""
