"""The yardstick's general code: finding a cell's files by name (spec),
drawing its inputs (traffic), serving them (serve), judging the answers
(check), counting its FHE operations (census) and reading the device trace
(trace, graph)."""
