"""Monitoring and control interfaces of the PyTorch port: the TCP
telecommand server (tcp_cmd.py)."""
