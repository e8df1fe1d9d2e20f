"""Launch layer of the port: the GSPMD backend's train step (``dist``) and the
client groups its exchange crosses (``mesh``)."""
