# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: auron_tpu/proto/plan.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1a\x61uron_tpu/proto/plan.proto\x12\tauron_tpu\"\xf4\x02\n\x08\x44\x61taType\x12&\n\x04kind\x18\x01 \x01(\x0e\x32\x18.auron_tpu.DataType.Kind\x12\x11\n\tprecision\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\r\x12\"\n\x05inner\x18\x04 \x01(\x0b\x32\x13.auron_tpu.DataType\x12#\n\x06inners\x18\x05 \x03(\x0b\x32\x13.auron_tpu.DataType\x12\x14\n\x0cstruct_names\x18\x06 \x03(\t\"\xbe\x01\n\x04Kind\x12\x08\n\x04NULL\x10\x00\x12\x08\n\x04\x42OOL\x10\x01\x12\x08\n\x04INT8\x10\x02\x12\t\n\x05INT16\x10\x03\x12\t\n\x05INT32\x10\x04\x12\t\n\x05INT64\x10\x05\x12\x0b\n\x07\x46LOAT32\x10\x06\x12\x0b\n\x07\x46LOAT64\x10\x07\x12\x0b\n\x07\x44\x45\x43IMAL\x10\x08\x12\n\n\x06\x44\x41TE32\x10\t\x12\r\n\tTIMESTAMP\x10\n\x12\n\n\x06STRING\x10\x0b\x12\n\n\x06\x42INARY\x10\x0c\x12\x08\n\x04LIST\x10\r\x12\x07\n\x03MAP\x10\x0e\x12\n\n\x06STRUCT\x10\x0f\"K\n\x05\x46ield\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\"\n\x05\x64type\x18\x02 \x01(\x0b\x32\x13.auron_tpu.DataType\x12\x10\n\x08nullable\x18\x03 \x01(\x08\"*\n\x06Schema\x12 \n\x06\x66ields\x18\x01 \x03(\x0b\x32\x10.auron_tpu.Field\"\xa2\x06\n\x10PhysicalExprNode\x12\'\n\x06\x63olumn\x18\x01 \x01(\x0b\x32\x15.auron_tpu.ColumnExprH\x00\x12)\n\x07literal\x18\x02 \x01(\x0b\x32\x16.auron_tpu.LiteralExprH\x00\x12#\n\x04\x63\x61st\x18\x03 \x01(\x0b\x32\x13.auron_tpu.CastExprH\x00\x12\'\n\x06\x62inary\x18\x04 \x01(\x0b\x32\x15.auron_tpu.BinaryExprH\x00\x12\'\n\x07is_null\x18\x05 \x01(\x0b\x32\x14.auron_tpu.UnaryExprH\x00\x12+\n\x0bis_not_null\x18\x06 \x01(\x0b\x32\x14.auron_tpu.UnaryExprH\x00\x12#\n\x03not\x18\x07 \x01(\x0b\x32\x14.auron_tpu.UnaryExprH\x00\x12$\n\x07if_expr\x18\x08 \x01(\x0b\x32\x11.auron_tpu.IfExprH\x00\x12(\n\tcase_expr\x18\t \x01(\x0b\x32\x13.auron_tpu.CaseExprH\x00\x12$\n\x07in_list\x18\n \x01(\x0b\x32\x11.auron_tpu.InExprH\x00\x12+\n\x08\x63oalesce\x18\x0b \x01(\x0b\x32\x17.auron_tpu.CoalesceExprH\x00\x12#\n\x04like\x18\x0c \x01(\x0b\x32\x13.auron_tpu.LikeExprH\x00\x12\x30\n\x0bscalar_func\x18\r \x01(\x0b\x32\x19.auron_tpu.ScalarFuncExprH\x00\x12*\n\x08host_udf\x18\x0e \x01(\x0b\x32\x16.auron_tpu.HostUdfExprH\x00\x12\x32\n\x12spark_partition_id\x18\x0f \x01(\x0b\x32\x14.auron_tpu.NoArgExprH\x00\x12,\n\x0cmonotonic_id\x18\x10 \x01(\x0b\x32\x14.auron_tpu.NoArgExprH\x00\x12\'\n\x07row_num\x18\x11 \x01(\x0b\x32\x14.auron_tpu.NoArgExprH\x00\x12\x38\n\x0fscalar_subquery\x18\x12 \x01(\x0b\x32\x1d.auron_tpu.ScalarSubqueryExprH\x00\x42\x06\n\x04\x65xpr\"\x0b\n\tNoArgExpr\"M\n\x12ScalarSubqueryExpr\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12\"\n\x05\x64type\x18\x02 \x01(\x0b\x32\x13.auron_tpu.DataType\")\n\nColumnExpr\x12\r\n\x05index\x18\x01 \x01(\r\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xd8\x01\n\x0bLiteralExpr\x12\"\n\x05\x64type\x18\x01 \x01(\x0b\x32\x13.auron_tpu.DataType\x12\x0f\n\x07is_null\x18\x02 \x01(\x08\x12\x14\n\nbool_value\x18\x03 \x01(\x08H\x00\x12\x13\n\tint_value\x18\x04 \x01(\x03H\x00\x12\x15\n\x0b\x66loat_value\x18\x05 \x01(\x01H\x00\x12\x16\n\x0cstring_value\x18\x06 \x01(\tH\x00\x12\x15\n\x0b\x62ytes_value\x18\x07 \x01(\x0cH\x00\x12\x1a\n\x10\x64\x65\x63imal_unscaled\x18\x08 \x01(\x12H\x00\x42\x07\n\x05value\"i\n\x08\x43\x61stExpr\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x1f\n\x02to\x18\x02 \x01(\x0b\x32\x13.auron_tpu.DataType\x12\x10\n\x08try_cast\x18\x03 \x01(\x08\"o\n\nBinaryExpr\x12\n\n\x02op\x18\x01 \x01(\t\x12)\n\x04left\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12*\n\x05right\x18\x03 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"7\n\tUnaryExpr\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"\x8b\x01\n\x06IfExpr\x12)\n\x04\x63ond\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12)\n\x04then\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12+\n\x06orelse\x18\x03 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"\xc5\x01\n\x08\x43\x61seExpr\x12,\n\x08\x62ranches\x18\x01 \x03(\x0b\x32\x1a.auron_tpu.CaseExpr.Branch\x12+\n\x06orelse\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x1a^\n\x06\x42ranch\x12)\n\x04when\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12)\n\x04then\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"l\n\x06InExpr\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12%\n\x05items\x18\x02 \x03(\x0b\x32\x16.auron_tpu.LiteralExpr\x12\x0f\n\x07negated\x18\x03 \x01(\x08\"9\n\x0c\x43oalesceExpr\x12)\n\x04\x61rgs\x18\x01 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"h\n\x08LikeExpr\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x0f\n\x07pattern\x18\x02 \x01(\t\x12\x0f\n\x07negated\x18\x03 \x01(\x08\x12\x0e\n\x06\x65scape\x18\x04 \x01(\t\"\x88\x01\n\x0eScalarFuncExpr\x12\x0c\n\x04name\x18\x01 \x01(\t\x12)\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12&\n\tout_dtype\x18\x03 \x01(\x0b\x32\x13.auron_tpu.DataType\x12\x15\n\rhas_out_dtype\x18\x04 \x01(\x08\"n\n\x0bHostUdfExpr\x12\x0c\n\x04name\x18\x01 \x01(\t\x12)\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12&\n\tout_dtype\x18\x03 \x01(\x0b\x32\x13.auron_tpu.DataType\"X\n\tSortField\x12)\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x0b\n\x03\x61sc\x18\x02 \x01(\x08\x12\x13\n\x0bnulls_first\x18\x03 \x01(\x08\"\x8c\x01\n\x0b\x41ggExprSpec\x12$\n\x04\x66unc\x18\x01 \x01(\x0e\x32\x16.auron_tpu.AggFunction\x12)\n\x04\x65xpr\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x10\n\x08has_expr\x18\x03 \x01(\x08\x12\x0c\n\x04name\x18\x04 \x01(\t\x12\x0c\n\x04udaf\x18\x05 \x01(\t\"D\n\tNamedExpr\x12)\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x0c\n\x04name\x18\x02 \x01(\t\"\x9b\x01\n\x0eWindowFuncSpec\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x0b\n\x03\x61gg\x18\x02 \x01(\t\x12)\n\x04\x65xpr\x18\x03 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x10\n\x08has_expr\x18\x04 \x01(\x08\x12\x0e\n\x06offset\x18\x05 \x01(\x05\x12\x13\n\x0b\x66rame_whole\x18\x06 \x01(\x08\x12\x0c\n\x04name\x18\x07 \x01(\t\"\xa3\x02\n\x0cPartitioning\x12*\n\x04kind\x18\x01 \x01(\x0e\x32\x1c.auron_tpu.Partitioning.Kind\x12\x16\n\x0enum_partitions\x18\x02 \x01(\r\x12/\n\nhash_exprs\x18\x03 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12*\n\x0crange_fields\x18\x04 \x03(\x0b\x32\x14.auron_tpu.SortField\x12\x19\n\x11range_bound_words\x18\x05 \x03(\x04\x12\x1d\n\x15range_words_per_bound\x18\x06 \x01(\r\"8\n\x04Kind\x12\n\n\x06SINGLE\x10\x00\x12\x08\n\x04HASH\x10\x01\x12\x0f\n\x0bROUND_ROBIN\x10\x02\x12\t\n\x05RANGE\x10\x03\"\xa9\n\n\x10PhysicalPlanNode\x12\x30\n\x0bmemory_scan\x18\x01 \x01(\x0b\x32\x19.auron_tpu.MemoryScanNodeH\x00\x12.\n\nffi_reader\x18\x02 \x01(\x0b\x32\x18.auron_tpu.FfiReaderNodeH\x00\x12\x32\n\x0cparquet_scan\x18\x03 \x01(\x0b\x32\x1a.auron_tpu.ParquetScanNodeH\x00\x12)\n\x07project\x18\x04 \x01(\x0b\x32\x16.auron_tpu.ProjectNodeH\x00\x12\'\n\x06\x66ilter\x18\x05 \x01(\x0b\x32\x15.auron_tpu.FilterNodeH\x00\x12%\n\x05limit\x18\x06 \x01(\x0b\x32\x14.auron_tpu.LimitNodeH\x00\x12%\n\x05union\x18\x07 \x01(\x0b\x32\x14.auron_tpu.UnionNodeH\x00\x12\'\n\x06\x65xpand\x18\x08 \x01(\x0b\x32\x15.auron_tpu.ExpandNodeH\x00\x12\x36\n\x0erename_columns\x18\t \x01(\x0b\x32\x1c.auron_tpu.RenameColumnsNodeH\x00\x12:\n\x10\x65mpty_partitions\x18\n \x01(\x0b\x32\x1e.auron_tpu.EmptyPartitionsNodeH\x00\x12:\n\x10\x63oalesce_batches\x18\x0b \x01(\x0b\x32\x1e.auron_tpu.CoalesceBatchesNodeH\x00\x12*\n\x08hash_agg\x18\x0c \x01(\x0b\x32\x16.auron_tpu.HashAggNodeH\x00\x12#\n\x04sort\x18\r \x01(\x0b\x32\x13.auron_tpu.SortNodeH\x00\x12\x37\n\x0fsort_merge_join\x18\x0e \x01(\x0b\x32\x1c.auron_tpu.SortMergeJoinNodeH\x00\x12,\n\thash_join\x18\x0f \x01(\x0b\x32\x17.auron_tpu.HashJoinNodeH\x00\x12\x36\n\x0eshuffle_writer\x18\x10 \x01(\x0b\x32\x1c.auron_tpu.ShuffleWriterNodeH\x00\x12.\n\nipc_reader\x18\x11 \x01(\x0b\x32\x18.auron_tpu.IpcReaderNodeH\x00\x12\'\n\x06window\x18\x12 \x01(\x0b\x32\x15.auron_tpu.WindowNodeH\x00\x12+\n\x08generate\x18\x13 \x01(\x0b\x32\x17.auron_tpu.GenerateNodeH\x00\x12\x32\n\x0cparquet_sink\x18\x14 \x01(\x0b\x32\x1a.auron_tpu.ParquetSinkNodeH\x00\x12.\n\nipc_writer\x18\x15 \x01(\x0b\x32\x18.auron_tpu.IpcWriterNodeH\x00\x12%\n\x05\x64\x65\x62ug\x18\x16 \x01(\x0b\x32\x14.auron_tpu.DebugNodeH\x00\x12*\n\x08orc_scan\x18\x17 \x01(\x0b\x32\x16.auron_tpu.OrcScanNodeH\x00\x12*\n\x08orc_sink\x18\x18 \x01(\x0b\x32\x16.auron_tpu.OrcSinkNodeH\x00\x12=\n\x12rss_shuffle_writer\x18\x19 \x01(\x0b\x32\x1f.auron_tpu.RssShuffleWriterNodeH\x00\x12\x34\n\rmesh_exchange\x18\x1a \x01(\x0b\x32\x1b.auron_tpu.MeshExchangeNodeH\x00\x12.\n\nkafka_scan\x18\x1b \x01(\x0b\x32\x18.auron_tpu.KafkaScanNodeH\x00\x42\x06\n\x04plan\"\x82\x01\n\x10MeshExchangeNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12-\n\x0cpartitioning\x18\x02 \x01(\x0b\x32\x17.auron_tpu.Partitioning\x12\x13\n\x0b\x65xchange_id\x18\x03 \x01(\t\"\x8a\x01\n\x14RssShuffleWriterNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12-\n\x0cpartitioning\x18\x02 \x01(\x0b\x32\x17.auron_tpu.Partitioning\x12\x17\n\x0frss_resource_id\x18\x03 \x01(\t\"\xc3\x01\n\x0bOrcScanNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\x12\n\nfile_paths\x18\x02 \x03(\t\x12\x37\n\x12pruning_predicates\x18\x03 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x16\n\x0e\x66s_resource_id\x18\x04 \x01(\t\x12,\n\npartitions\x18\x05 \x03(\x0b\x32\x18.auron_tpu.FilePartition\"\xae\x01\n\x0bOrcSinkNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x13\n\x0boutput_path\x18\x02 \x01(\t\x12\x30\n\x05props\x18\x03 \x03(\x0b\x32!.auron_tpu.OrcSinkNode.PropsEntry\x1a,\n\nPropsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"H\n\x0eMemoryScanNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\x13\n\x0bresource_id\x18\x02 \x01(\t\"G\n\rFfiReaderNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\x13\n\x0bresource_id\x18\x02 \x01(\t\"\x1e\n\rFilePartition\x12\r\n\x05paths\x18\x01 \x03(\t\"\xc7\x01\n\x0fParquetScanNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\x12\n\nfile_paths\x18\x02 \x03(\t\x12\x37\n\x12pruning_predicates\x18\x03 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x16\n\x0e\x66s_resource_id\x18\x04 \x01(\t\x12,\n\npartitions\x18\x05 \x03(\x0b\x32\x18.auron_tpu.FilePartition\"^\n\x0bProjectNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12#\n\x05\x65xprs\x18\x02 \x03(\x0b\x32\x14.auron_tpu.NamedExpr\"i\n\nFilterNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12/\n\npredicates\x18\x02 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"F\n\tLimitNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\r\n\x05limit\x18\x02 \x01(\x04\":\n\tUnionNode\x12-\n\x08\x63hildren\x18\x01 \x03(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\"\xb8\x01\n\nExpandNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x35\n\x0bprojections\x18\x02 \x03(\x0b\x32 .auron_tpu.ExpandNode.Projection\x12\r\n\x05names\x18\x03 \x03(\t\x1a\x38\n\nProjection\x12*\n\x05\x65xprs\x18\x01 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\"N\n\x11RenameColumnsNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\r\n\x05names\x18\x02 \x03(\t\"P\n\x13\x45mptyPartitionsNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\x16\n\x0enum_partitions\x18\x02 \x01(\r\"V\n\x13\x43oalesceBatchesNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x13\n\x0btarget_rows\x18\x02 \x01(\r\"\xaa\x01\n\x0bHashAggNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\'\n\tgroupings\x18\x02 \x03(\x0b\x32\x14.auron_tpu.NamedExpr\x12$\n\x04\x61ggs\x18\x03 \x03(\x0b\x32\x16.auron_tpu.AggExprSpec\x12 \n\x04mode\x18\x04 \x01(\x0e\x32\x12.auron_tpu.AggMode\"~\n\x08SortNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12$\n\x06\x66ields\x18\x02 \x03(\x0b\x32\x14.auron_tpu.SortField\x12\r\n\x05\x66\x65tch\x18\x03 \x01(\x04\x12\x11\n\thas_fetch\x18\x04 \x01(\x08\"\xfa\x02\n\x11SortMergeJoinNode\x12)\n\x04left\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12*\n\x05right\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12.\n\tleft_keys\x18\x03 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12/\n\nright_keys\x18\x04 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12&\n\tjoin_type\x18\x05 \x01(\x0e\x32\x13.auron_tpu.JoinType\x12.\n\tcondition\x18\x06 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x15\n\rhas_condition\x18\x07 \x01(\x08\x12\x12\n\nexists_col\x18\x08 \x01(\t\x12\x12\n\nprojection\x18\t \x03(\r\x12\x16\n\x0ehas_projection\x18\n \x01(\x08\"\xb8\x03\n\x0cHashJoinNode\x12)\n\x04left\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12*\n\x05right\x18\x02 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12.\n\tleft_keys\x18\x03 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12/\n\nright_keys\x18\x04 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12&\n\tjoin_type\x18\x05 \x01(\x0e\x32\x13.auron_tpu.JoinType\x12(\n\nbuild_side\x18\x06 \x01(\x0e\x32\x14.auron_tpu.BuildSide\x12.\n\tcondition\x18\x07 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x15\n\rhas_condition\x18\x08 \x01(\x08\x12\x17\n\x0f\x63\x61\x63hed_build_id\x18\t \x01(\t\x12\x12\n\nexists_col\x18\n \x01(\t\x12\x12\n\nprojection\x18\x0b \x03(\r\x12\x16\n\x0ehas_projection\x18\x0c \x01(\x08\"\xa3\x01\n\x11ShuffleWriterNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12-\n\x0cpartitioning\x18\x02 \x01(\x0b\x32\x17.auron_tpu.Partitioning\x12\x18\n\x10output_data_file\x18\x03 \x01(\t\x12\x19\n\x11output_index_file\x18\x04 \x01(\t\"G\n\rIpcReaderNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\x13\n\x0bresource_id\x18\x02 \x01(\t\"\xbd\x01\n\nWindowNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x31\n\x0cpartition_by\x18\x02 \x03(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12&\n\x08order_by\x18\x03 \x03(\x0b\x32\x14.auron_tpu.SortField\x12(\n\x05\x66uncs\x18\x04 \x03(\x0b\x32\x19.auron_tpu.WindowFuncSpec\"\xea\x01\n\x0cGenerateNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x11\n\tgenerator\x18\x02 \x01(\t\x12-\n\x08gen_expr\x18\x03 \x01(\x0b\x32\x1b.auron_tpu.PhysicalExprNode\x12\x15\n\rrequired_cols\x18\x04 \x03(\r\x12\r\n\x05outer\x18\x05 \x01(\x08\x12\x13\n\x0bjson_fields\x18\x06 \x03(\t\x12\x11\n\telem_name\x18\x07 \x01(\t\x12\x10\n\x08pos_name\x18\x08 \x01(\t\x12\x0c\n\x04udtf\x18\t \x01(\t\"\xcc\x01\n\x0fParquetSinkNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x13\n\x0boutput_path\x18\x02 \x01(\t\x12\x34\n\x05props\x18\x03 \x03(\x0b\x32%.auron_tpu.ParquetSinkNode.PropsEntry\x12\x14\n\x0cpartition_by\x18\x04 \x03(\t\x1a,\n\nPropsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"P\n\rIpcWriterNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x13\n\x0bresource_id\x18\x02 \x01(\t\"D\n\tDebugNode\x12*\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x0b\n\x03tag\x18\x02 \x01(\t\"\xd3\x02\n\rKafkaScanNode\x12!\n\x06schema\x18\x01 \x01(\x0b\x32\x11.auron_tpu.Schema\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x14\n\x0cstartup_mode\x18\x03 \x01(\t\x12\x41\n\rstart_offsets\x18\x04 \x03(\x0b\x32*.auron_tpu.KafkaScanNode.StartOffsetsEntry\x12\x0e\n\x06\x66ormat\x18\x05 \x01(\t\x12\x10\n\x08on_error\x18\x06 \x01(\t\x12\x1a\n\x12source_resource_id\x18\x07 \x01(\t\x12\x14\n\x0cpb_field_ids\x18\x08 \x03(\r\x12\x19\n\x11max_batch_records\x18\t \x01(\r\x12\x13\n\x0bzigzag_cols\x18\n \x03(\r\x1a\x33\n\x11StartOffsetsEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"\xc3\x01\n\x0eTaskDefinition\x12)\n\x04plan\x18\x01 \x01(\x0b\x32\x1b.auron_tpu.PhysicalPlanNode\x12\x10\n\x08stage_id\x18\x02 \x01(\r\x12\x14\n\x0cpartition_id\x18\x03 \x01(\r\x12\x31\n\x04\x63onf\x18\x04 \x03(\x0b\x32#.auron_tpu.TaskDefinition.ConfEntry\x1a+\n\tConfEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01*\xcd\x01\n\x0b\x41ggFunction\x12\x0b\n\x07\x41GG_SUM\x10\x00\x12\r\n\tAGG_COUNT\x10\x01\x12\x12\n\x0e\x41GG_COUNT_STAR\x10\x02\x12\x0b\n\x07\x41GG_AVG\x10\x03\x12\x0b\n\x07\x41GG_MIN\x10\x04\x12\x0b\n\x07\x41GG_MAX\x10\x05\x12\r\n\tAGG_FIRST\x10\x06\x12\x1a\n\x16\x41GG_FIRST_IGNORES_NULL\x10\x07\x12\x14\n\x10\x41GG_COLLECT_LIST\x10\x08\x12\x13\n\x0f\x41GG_COLLECT_SET\x10\t\x12\x11\n\rAGG_HOST_UDAF\x10\n*@\n\x07\x41ggMode\x12\x0f\n\x0b\x41GG_PARTIAL\x10\x00\x12\x15\n\x11\x41GG_PARTIAL_MERGE\x10\x01\x12\r\n\tAGG_FINAL\x10\x02*\x84\x01\n\x08JoinType\x12\x0e\n\nJOIN_INNER\x10\x00\x12\r\n\tJOIN_LEFT\x10\x01\x12\x0e\n\nJOIN_RIGHT\x10\x02\x12\r\n\tJOIN_FULL\x10\x03\x12\x12\n\x0eJOIN_LEFT_SEMI\x10\x04\x12\x12\n\x0eJOIN_LEFT_ANTI\x10\x05\x12\x12\n\x0eJOIN_EXISTENCE\x10\x06*,\n\tBuildSide\x12\x0f\n\x0b\x42UILD_RIGHT\x10\x00\x12\x0e\n\nBUILD_LEFT\x10\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'auron_tpu.proto.plan_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ORCSINKNODE_PROPSENTRY._options = None
  _ORCSINKNODE_PROPSENTRY._serialized_options = b'8\001'
  _PARQUETSINKNODE_PROPSENTRY._options = None
  _PARQUETSINKNODE_PROPSENTRY._serialized_options = b'8\001'
  _KAFKASCANNODE_STARTOFFSETSENTRY._options = None
  _KAFKASCANNODE_STARTOFFSETSENTRY._serialized_options = b'8\001'
  _TASKDEFINITION_CONFENTRY._options = None
  _TASKDEFINITION_CONFENTRY._serialized_options = b'8\001'
  _AGGFUNCTION._serialized_start=9415
  _AGGFUNCTION._serialized_end=9620
  _AGGMODE._serialized_start=9622
  _AGGMODE._serialized_end=9686
  _JOINTYPE._serialized_start=9689
  _JOINTYPE._serialized_end=9821
  _BUILDSIDE._serialized_start=9823
  _BUILDSIDE._serialized_end=9867
  _DATATYPE._serialized_start=42
  _DATATYPE._serialized_end=414
  _DATATYPE_KIND._serialized_start=224
  _DATATYPE_KIND._serialized_end=414
  _FIELD._serialized_start=416
  _FIELD._serialized_end=491
  _SCHEMA._serialized_start=493
  _SCHEMA._serialized_end=535
  _PHYSICALEXPRNODE._serialized_start=538
  _PHYSICALEXPRNODE._serialized_end=1340
  _NOARGEXPR._serialized_start=1342
  _NOARGEXPR._serialized_end=1353
  _SCALARSUBQUERYEXPR._serialized_start=1355
  _SCALARSUBQUERYEXPR._serialized_end=1432
  _COLUMNEXPR._serialized_start=1434
  _COLUMNEXPR._serialized_end=1475
  _LITERALEXPR._serialized_start=1478
  _LITERALEXPR._serialized_end=1694
  _CASTEXPR._serialized_start=1696
  _CASTEXPR._serialized_end=1801
  _BINARYEXPR._serialized_start=1803
  _BINARYEXPR._serialized_end=1914
  _UNARYEXPR._serialized_start=1916
  _UNARYEXPR._serialized_end=1971
  _IFEXPR._serialized_start=1974
  _IFEXPR._serialized_end=2113
  _CASEEXPR._serialized_start=2116
  _CASEEXPR._serialized_end=2313
  _CASEEXPR_BRANCH._serialized_start=2219
  _CASEEXPR_BRANCH._serialized_end=2313
  _INEXPR._serialized_start=2315
  _INEXPR._serialized_end=2423
  _COALESCEEXPR._serialized_start=2425
  _COALESCEEXPR._serialized_end=2482
  _LIKEEXPR._serialized_start=2484
  _LIKEEXPR._serialized_end=2588
  _SCALARFUNCEXPR._serialized_start=2591
  _SCALARFUNCEXPR._serialized_end=2727
  _HOSTUDFEXPR._serialized_start=2729
  _HOSTUDFEXPR._serialized_end=2839
  _SORTFIELD._serialized_start=2841
  _SORTFIELD._serialized_end=2929
  _AGGEXPRSPEC._serialized_start=2932
  _AGGEXPRSPEC._serialized_end=3072
  _NAMEDEXPR._serialized_start=3074
  _NAMEDEXPR._serialized_end=3142
  _WINDOWFUNCSPEC._serialized_start=3145
  _WINDOWFUNCSPEC._serialized_end=3300
  _PARTITIONING._serialized_start=3303
  _PARTITIONING._serialized_end=3594
  _PARTITIONING_KIND._serialized_start=3538
  _PARTITIONING_KIND._serialized_end=3594
  _PHYSICALPLANNODE._serialized_start=3597
  _PHYSICALPLANNODE._serialized_end=4918
  _MESHEXCHANGENODE._serialized_start=4921
  _MESHEXCHANGENODE._serialized_end=5051
  _RSSSHUFFLEWRITERNODE._serialized_start=5054
  _RSSSHUFFLEWRITERNODE._serialized_end=5192
  _ORCSCANNODE._serialized_start=5195
  _ORCSCANNODE._serialized_end=5390
  _ORCSINKNODE._serialized_start=5393
  _ORCSINKNODE._serialized_end=5567
  _ORCSINKNODE_PROPSENTRY._serialized_start=5523
  _ORCSINKNODE_PROPSENTRY._serialized_end=5567
  _MEMORYSCANNODE._serialized_start=5569
  _MEMORYSCANNODE._serialized_end=5641
  _FFIREADERNODE._serialized_start=5643
  _FFIREADERNODE._serialized_end=5714
  _FILEPARTITION._serialized_start=5716
  _FILEPARTITION._serialized_end=5746
  _PARQUETSCANNODE._serialized_start=5749
  _PARQUETSCANNODE._serialized_end=5948
  _PROJECTNODE._serialized_start=5950
  _PROJECTNODE._serialized_end=6044
  _FILTERNODE._serialized_start=6046
  _FILTERNODE._serialized_end=6151
  _LIMITNODE._serialized_start=6153
  _LIMITNODE._serialized_end=6223
  _UNIONNODE._serialized_start=6225
  _UNIONNODE._serialized_end=6283
  _EXPANDNODE._serialized_start=6286
  _EXPANDNODE._serialized_end=6470
  _EXPANDNODE_PROJECTION._serialized_start=6414
  _EXPANDNODE_PROJECTION._serialized_end=6470
  _RENAMECOLUMNSNODE._serialized_start=6472
  _RENAMECOLUMNSNODE._serialized_end=6550
  _EMPTYPARTITIONSNODE._serialized_start=6552
  _EMPTYPARTITIONSNODE._serialized_end=6632
  _COALESCEBATCHESNODE._serialized_start=6634
  _COALESCEBATCHESNODE._serialized_end=6720
  _HASHAGGNODE._serialized_start=6723
  _HASHAGGNODE._serialized_end=6893
  _SORTNODE._serialized_start=6895
  _SORTNODE._serialized_end=7021
  _SORTMERGEJOINNODE._serialized_start=7024
  _SORTMERGEJOINNODE._serialized_end=7402
  _HASHJOINNODE._serialized_start=7405
  _HASHJOINNODE._serialized_end=7845
  _SHUFFLEWRITERNODE._serialized_start=7848
  _SHUFFLEWRITERNODE._serialized_end=8011
  _IPCREADERNODE._serialized_start=8013
  _IPCREADERNODE._serialized_end=8084
  _WINDOWNODE._serialized_start=8087
  _WINDOWNODE._serialized_end=8276
  _GENERATENODE._serialized_start=8279
  _GENERATENODE._serialized_end=8513
  _PARQUETSINKNODE._serialized_start=8516
  _PARQUETSINKNODE._serialized_end=8720
  _PARQUETSINKNODE_PROPSENTRY._serialized_start=5523
  _PARQUETSINKNODE_PROPSENTRY._serialized_end=5567
  _IPCWRITERNODE._serialized_start=8722
  _IPCWRITERNODE._serialized_end=8802
  _DEBUGNODE._serialized_start=8804
  _DEBUGNODE._serialized_end=8872
  _KAFKASCANNODE._serialized_start=8875
  _KAFKASCANNODE._serialized_end=9214
  _KAFKASCANNODE_STARTOFFSETSENTRY._serialized_start=9163
  _KAFKASCANNODE_STARTOFFSETSENTRY._serialized_end=9214
  _TASKDEFINITION._serialized_start=9217
  _TASKDEFINITION._serialized_end=9412
  _TASKDEFINITION_CONFENTRY._serialized_start=9369
  _TASKDEFINITION_CONFENTRY._serialized_end=9412
# @@protoc_insertion_point(module_scope)
