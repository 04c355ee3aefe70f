"""Language models of the port: configuration and parameters (``common``),
layers (``layers``) and assembly (``lm``).  The dense family is ported."""
