"""The benchmark's own machinery: the manifest and its plug-ins, the
traffic generators, timing arithmetic, the device-trace reduction, the
table of peaks and the comparisons that decide ``correct``. Nothing here
imports the program under test at module level."""
