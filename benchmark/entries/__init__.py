"""The program entries that traffic mixes drive, one file each, found by
the ``entry`` of a traffic file."""
