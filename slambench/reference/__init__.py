"""The benchmark's plain reference (`slamref`, a frozen copy of the
port's eager bodies) and the stage checks built on it (`stages`)."""
