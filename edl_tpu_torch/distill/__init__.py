"""The distillation service plane of the port: the teacher server and
the student's read path (``DistillReader``, discovery clients)."""
