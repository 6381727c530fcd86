"""Operations, bytes and FLOPs of the served work, from a configuration and
a cell's shapes alone (never from the program's modules), and the chip's
published peaks."""
