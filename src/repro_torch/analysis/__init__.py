"""Runtime checks of the serving stack's compile-once discipline (port of
`repro/analysis`): `sanitizer` counts step captures and explicit host
syncs and enforces the engines' declared budgets."""
