"""The distillation service plane of the port: the teacher server."""
