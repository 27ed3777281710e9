"""Device stages of the torch port (counterparts of dbgtpu/engine)."""
