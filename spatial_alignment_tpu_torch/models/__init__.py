"""Model spec, parameters, core functions and the user-facing model."""
