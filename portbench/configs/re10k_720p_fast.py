"""re10k_720p_fast: served. The program's side is the port's serving path
(``main.test``), the plain reference's side the frozen copy in float32
(``portbench.sides``); ``serve_reference(..., precision="fp8")`` is the
control."""

from portbench.sides import serve_program, serve_reference

__all__ = ["serve_program", "serve_reference"]
