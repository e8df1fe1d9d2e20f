"""Launch layer of the port: the GSPMD backend's train step."""
